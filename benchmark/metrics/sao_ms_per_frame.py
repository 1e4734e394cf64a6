"""Loop filters, SAO (ops/sao.py, native estimate and apply): the
utils.timing section sao, ms a picture of the window."""


def read(ctx):
    secs = ctx["sections"].get("sao")
    if secs is None or not ctx["pictures"]:
        return None
    return secs / ctx["pictures"] * 1e3
