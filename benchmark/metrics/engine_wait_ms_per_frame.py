"""Host CU engine (entropy/native/api.cpp hevc_engine_frame): worker time
from a failed check of the CTU row above until it passes, summed over
the wavefront's workers (the engine's trace counter engine_wait_s), ms a
picture of the window. The sequential path reads 0."""


def read(ctx):
    eng = ctx["engine"]
    if (not eng or not eng.get("engine_traced_frames")
            or not ctx["pictures"]):
        return None
    return eng["engine_wait_s"] / ctx["pictures"] * 1e3
