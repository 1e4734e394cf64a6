"""Host CU engine (entropy/native/engine.cpp): worker time in the `other`
stage of the engine's trace counters (what no stage claims: the CU-split
choices and their snapshots, the shadow entropy coder, per-CTU set-up),
summed over the wavefront's workers, ms a picture of the window. The
stages split the workers' time inside encode_ctu exactly."""


def read(ctx):
    eng = ctx["engine"]
    if (not eng or not eng.get("engine_traced_frames")
            or not ctx["pictures"]):
        return None
    return eng["engine_other_s"] / ctx["pictures"] * 1e3
