"""Host CU engine (entropy/native/engine.cpp): intra luma modes taken
through full RD (predicted, transformed, quantised, reconstructed and
rated) a picture of the window, the engine's trace counter
engine_intra_rd_modes: what the intra stage's worker-ms buy. A program
without the counter reads nothing."""


def read(ctx):
    eng = ctx["engine"]
    if (not eng or not eng.get("engine_traced_frames")
            or "engine_intra_rd_modes" not in eng or not ctx["pictures"]):
        return None
    return eng["engine_intra_rd_modes"] / ctx["pictures"]
