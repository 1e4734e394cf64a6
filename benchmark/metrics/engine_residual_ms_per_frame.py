"""Host CU engine (entropy/native/engine.cpp): worker time in the
`residual` stage of the engine's trace counters (TB coding: transform,
quantization, RDOQ, rate, reconstruction and the residual commit),
summed over the wavefront's workers, ms a picture of the window. The
stages split the workers' time inside encode_ctu exactly."""


def read(ctx):
    eng = ctx["engine"]
    if (not eng or not eng.get("engine_traced_frames")
            or not ctx["pictures"]):
        return None
    return eng["engine_residual_s"] / ctx["pictures"] * 1e3
