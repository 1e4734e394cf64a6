"""Host CU engine (entropy/native/engine.cpp): worker time in the
`inter_search` stage of the engine's trace counters (inter search: AMVP,
fractional and bi refinement, the split screen and rectangular/AMP
motion), summed over the wavefront's workers, ms a picture of the
window. The stages split the workers' time inside encode_ctu exactly."""


def read(ctx):
    eng = ctx["engine"]
    if (not eng or not eng.get("engine_traced_frames")
            or not ctx["pictures"]):
        return None
    return eng["engine_inter_search_s"] / ctx["pictures"] * 1e3
