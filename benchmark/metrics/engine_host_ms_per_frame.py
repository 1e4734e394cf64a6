"""Host CU engine (encoder/native_frame.py -> entropy/native/engine.cpp):
the utils.timing section engine_host, ms a picture of the window."""


def read(ctx):
    secs = ctx["sections"].get("engine_host")
    if secs is None or not ctx["pictures"]:
        return None
    return secs / ctx["pictures"] * 1e3
