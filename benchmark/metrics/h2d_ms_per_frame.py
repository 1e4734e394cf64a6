"""Uploads (runtime.py, ops/me_ssd.py): profiled device time of the
host-to-device copies in the window, ms a picture."""


def read(ctx):
    secs = [(t - s) / 1e6 for n, s, t in ctx["profile"]["device"]
            if n.startswith("Memcpy HtoD")]
    if not secs or not ctx["pictures"]:
        return None
    return sum(secs) / ctx["pictures"] * 1e3
