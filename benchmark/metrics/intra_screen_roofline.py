"""Kernel intra_screen (csrc/intra_screen.cu intra_screen_kernel<N, Pel>,
one launch a block size): the least time of its launches in the window
over their profiled device time, in percent.

A launch's operations and bytes follow from the cell's picture size, as
the repo's chip smoke test counts them: 35 modes x blocks x N^2 predicted
samples, each 9 operations (the angular blend, the difference, abs and
sum) plus the Hadamard butterflies (6 for N >= 8, 4 for the 4x4 tiles);
bytes are the padded plane read once, the 35 mode costs, and the
candidates and best costs written. Operations bound it, against the
float32 rate; integer adds, shifts and logic run at half that rate, so
about 50% is the most the kernel can reach (its own comment)."""
from benchmark.harness import roofline, trace

# candidates kept a block, by block side (ops/intra_screen.py K_OF_LOG2)
CANDS = {4: 0, 8: 8, 16: 3, 32: 3}


def cost(ctx, n: int, pel_bytes: int):
    """(bytes, operations) of one launch over the picture's n x n
    blocks."""
    h, w = ctx["height"], ctx["width"]
    blocks = (h // n) * (w // n)
    ops = 35.0 * blocks * n * n * (9 + (6 if n >= 8 else 4))
    nbytes = ((h + 1) * (w + 1) * pel_bytes + 35 * 4
              + blocks * CANDS[n] + blocks * 4)
    return nbytes, ops


def read(ctx):
    ev = trace.kernel_events(ctx["profile"],
                             r"intra_screen_kernel<(\d+), *(\w+)>")
    if not ev:
        return None
    bound = sum(roofline.bound_s(*cost(ctx, int(m.group(1)),
                                       2 if m.group(2) == "short" else 4),
                                 roofline.SCALAR32_OPS) for m, _ in ev)
    return roofline.share(bound, sum(t for _, t in ev))
