"""Motion search, host side (encoder/native_frame.py): the share of inter
pictures whose integer search came from the one-picture lookahead
(utils.timing counters me_lookahead_taken over me_searched), in %."""
from hevc_tpu_torch.utils.timing import timers


def read(ctx):
    searched = timers.count.get("me_searched", 0)
    if not searched:
        return None
    return 100.0 * timers.count.get("me_lookahead_taken", 0) / searched
