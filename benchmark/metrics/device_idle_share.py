"""Device: 1 minus the union of the profiler's device intervals over the
window's length, in percent (the arithmetic of the chip smoke test's
busy share)."""
from benchmark.harness import trace


def read(ctx):
    prof = ctx["profile"]
    if not prof["device"] or prof["window_us"] is None:
        return None
    a, b = prof["window_us"]
    return 100.0 * (1.0 - trace.busy_us(prof["device"]) / (b - a))
