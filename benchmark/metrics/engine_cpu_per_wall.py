"""Host CU engine: CPU seconds over wall seconds of the engine's frame
calls across the window (entropy/cabac.py engine_frame_stats), i.e. how
many cores the wavefront keeps busy."""


def read(ctx):
    eng = ctx["engine"]
    if not eng or eng["engine_wall_s"] <= 0:
        return None
    return eng["engine_cpu_s"] / eng["engine_wall_s"]
