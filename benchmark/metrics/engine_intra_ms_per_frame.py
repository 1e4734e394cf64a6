"""Host CU engine (entropy/native/engine.cpp): worker time in the `intra`
stage of the engine's trace counters (intra mode trials: the luma SATD
screen and exact-RD trials, chroma modes, NxN, and the intra screen and
trial of inter CUs), summed over the wavefront's workers, ms a picture
of the window. The stages split the workers' time inside encode_ctu
exactly."""


def read(ctx):
    eng = ctx["engine"]
    if (not eng or not eng.get("engine_traced_frames")
            or not ctx["pictures"]):
        return None
    return eng["engine_intra_s"] / ctx["pictures"] * 1e3
