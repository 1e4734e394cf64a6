"""Frame loop (encoder/top.py EncoderTop): the window's wall time less the
encoder's disjoint utils.timing sections, per picture, in ms. This is the
Python loop's own time: GOP bookkeeping, SEI, planes, the lookahead."""


def read(ctx):
    if not ctx["pictures"]:
        return None
    rest = ctx["window_s"] - sum(ctx["sections"].values())
    return rest / ctx["pictures"] * 1e3
