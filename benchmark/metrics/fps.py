"""The window's frames/s (pictures whose bytes came back in the window over
its wall time), read in the traced run: per layer in cells where the host's
noise leaves it too unsteady for an end-to-end bound."""


def read(ctx):
    if not ctx["pictures"] or ctx["window_s"] <= 0:
        return None
    return ctx["pictures"] / ctx["window_s"]
