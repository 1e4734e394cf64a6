"""Uploads (runtime.upload, through which every host-to-device copy of the
encode path goes): the bytes copied (utils.timing counter h2d_bytes), MB
(1e6 bytes) a picture of the window. Beside h2d_ms_per_frame it gives the
copies' bandwidth."""
from hevc_tpu_torch.utils.timing import timers


def read(ctx):
    n = timers.count.get("h2d_bytes")
    if n is None or not ctx["pictures"]:
        return None
    return n / 1e6 / ctx["pictures"]
