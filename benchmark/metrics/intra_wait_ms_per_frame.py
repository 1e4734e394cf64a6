"""Intra prescreen, host side (encoder/native_frame.py): the utils.timing
section intra_device, the host's wait for the prescreen's readback (or
for the whole screen where none was prefetched), ms a picture of the
window."""


def read(ctx):
    secs = ctx["sections"].get("intra_device")
    if secs is None or not ctx["pictures"]:
        return None
    return secs / ctx["pictures"] * 1e3
