"""Host CU engine (entropy/native/dsp.cpp fwd_xform, inv_xform): core
transforms, forward and inverse, of any size, a picture of the window, the
engine's trace counter engine_xforms: how much transform work the residual
and intra RD buy. A program without the counter reads nothing."""


def read(ctx):
    eng = ctx["engine"]
    if (not eng or not eng.get("engine_traced_frames")
            or "engine_xforms" not in eng or not ctx["pictures"]):
        return None
    return eng["engine_xforms"] / ctx["pictures"]
