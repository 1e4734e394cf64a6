"""90th percentile of the time from one step's bytes to the next's over the
traced window, in ms: per layer in cells where the host's noise leaves it
too unsteady for an end-to-end bound."""
from benchmark.harness import check


def read(ctx):
    if not ctx["steps"]:
        return None
    return check.frame_ms_p90(ctx["t0"], ctx["steps"])
