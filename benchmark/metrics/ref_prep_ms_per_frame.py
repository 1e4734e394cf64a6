"""Frame loop (encoder/top.py): the utils.timing loop span `ref_prep`
(reference preparation: host padding and device upload of reference
pictures (_padded_ref, _dev_ref) and the lookahead search's early and
late dispatches), ms a picture of the window. Loop spans are part of the
loop's own time (glue_ms_per_frame) and never overlap a section."""
from hevc_tpu_torch.utils.timing import timers


def read(ctx):
    loop = getattr(timers, "loop", None)
    if loop is None or not ctx["pictures"]:
        return None
    return loop.get("ref_prep", 0.0) / ctx["pictures"] * 1e3
