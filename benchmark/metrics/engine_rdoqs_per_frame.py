"""Host CU engine (entropy/native/syntax.cpp rdoq_quant): exact RDOQs of
TBs of any size, a picture of the window, the engine's trace counter
engine_rdoqs: how much quantisation work the residual and intra RD buy. A
program without the counter reads nothing."""


def read(ctx):
    eng = ctx["engine"]
    if (not eng or not eng.get("engine_traced_frames")
            or "engine_rdoqs" not in eng or not ctx["pictures"]):
        return None
    return eng["engine_rdoqs"] / ctx["pictures"]
