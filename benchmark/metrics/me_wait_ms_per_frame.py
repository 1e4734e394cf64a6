"""Motion search, host side (ops/me_ssd.py, runtime.Readback): the
utils.timing section me_device, the host's wait for the device search,
ms a picture of the window."""


def read(ctx):
    secs = ctx["sections"].get("me_device")
    if secs is None or not ctx["pictures"]:
        return None
    return secs / ctx["pictures"] * 1e3
