"""Frame loop (encoder/top.py): the utils.timing loop span `stream_write`
(the slice headers, SEI, the decoded-picture hash, NAL units and
Annex-B), ms a picture of the window. Loop spans are part of the loop's
own time (glue_ms_per_frame) and never overlap a section."""
from hevc_tpu_torch.utils.timing import timers


def read(ctx):
    loop = getattr(timers, "loop", None)
    if loop is None or not ctx["pictures"]:
        return None
    return loop.get("stream_write", 0.0) / ctx["pictures"] * 1e3
