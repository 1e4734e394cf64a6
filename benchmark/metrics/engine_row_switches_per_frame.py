"""Host CU engine (entropy/native/api.cpp hevc_engine_frame): CTU rows that
changed hands on the wavefront, a picture of the window (the engine's trace
counter engine_row_switches: a worker lets a row go when its next CTU is
blocked, or claims a row another worker let go). A program without the
counter, and the sequential path, read nothing."""


def read(ctx):
    eng = ctx["engine"]
    if (not eng or not eng.get("engine_traced_frames")
            or "engine_row_switches" not in eng or not ctx["pictures"]):
        return None
    return eng["engine_row_switches"] / ctx["pictures"]
