"""Intra prescreen, host side (encoder/native_frame.py): the share of I
pictures whose prescreen came from the lookahead (utils.timing counters
intra_lookahead_taken over intra_screened), in %. A program without the
counters, or a window that screened nothing, reads nothing."""
from hevc_tpu_torch.utils.timing import timers


def read(ctx):
    screened = timers.count.get("intra_screened", 0)
    if not screened:
        return None
    return 100.0 * timers.count.get("intra_lookahead_taken", 0) / screened
