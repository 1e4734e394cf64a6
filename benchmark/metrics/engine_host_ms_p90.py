"""Host CU engine (encoder/native_frame.py): the 90th percentile, over the
window's pictures, of each picture's engine_host time (its utils.timing
events summed by the picture they are for), in ms."""
import statistics

from hevc_tpu_torch.utils.timing import timers


def read(ctx):
    per = {}
    for name, t0, t1, picture in getattr(timers, "events", ()):
        if name == "engine_host" and picture is not None:
            per[picture] = per.get(picture, 0.0) + (t1 - t0)
    if not per:
        return None
    ms = [v * 1e3 for v in per.values()]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
