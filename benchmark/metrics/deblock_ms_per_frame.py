"""Loop filters, deblocking (ops/deblock.py, native path): the
utils.timing section deblock, ms a picture of the window."""


def read(ctx):
    secs = ctx["sections"].get("deblock")
    if secs is None or not ctx["pictures"]:
        return None
    return secs / ctx["pictures"] * 1e3
