"""Entropy coding (entropy/cabac.py -> native hevc_enc_frame): the
utils.timing section entropy, ms a picture of the window."""


def read(ctx):
    secs = ctx["sections"].get("entropy")
    if secs is None or not ctx["pictures"]:
        return None
    return secs / ctx["pictures"] * 1e3
