"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit) and
the least time a launch could take: the larger of its bytes over the HBM
rate and its operations over the rate of the unit it runs on. The
operation and byte counts of each kernel are those of the repo's chip
smoke test (phase 2), computed from the cell's shapes."""
from __future__ import annotations

HBM_BPS = 3.35e12
INT8_TC_OPS = 1979e12
SCALAR32_OPS = 67e12


def bound_s(nbytes: float, ops: float, op_rate: float) -> float:
    return max(nbytes / HBM_BPS, ops / op_rate)


def search_grids(ctx) -> dict:
    """{block size: (r, ny, nx)} of the two grids the encoder searches:
    half the CTU at the configuration's range, and half that at
    min(range, 16)."""
    size = ctx["ctu"] >> 1
    r = ctx["search_range"]
    h, w = ctx["height"], ctx["width"]
    out = {}
    for sz, rr in ((size, r), (size >> 1, min(r, 16))):
        out[sz] = (rr, (h - sz) // sz + 1, (w - sz) // sz + 1)
    return out


def ssd_cost(ctx, size: int, deep: bool):
    """(bytes, operations) of one SSD-table launch at this grid: the roi
    read once, the blocks read once and the table written once; two
    operations a multiply-add of the correlation, three int8 products of
    it on the deep path."""
    r, ny, nx = search_grids(ctx)[size]
    nyx = 2 * r + 1
    aw = 2 * r + size
    n = ny * nx
    esz = 2 if deep else 1
    roi = ((ny - 1) * size + aw) * ((nx - 1) * size + aw)
    nbytes = roi * esz + n * size * size * esz + n * nyx * nyx * 4
    ops = (3 if deep else 1) * 2.0 * n * nyx * nyx * size * size
    return nbytes, ops


def argmin_cost(ctx, size: int):
    """(bytes, operations) of one two-pass argmin launch at this grid:
    the table and the bits table read, one index a block written; nine
    neighbour adds and a compare in pass 1, two MV-bit terms, the rate
    product, an add and two compares in pass 2."""
    r, ny, nx = search_grids(ctx)[size]
    nyx = 2 * r + 1
    n = ny * nx
    return n * nyx * nyx * 4 + nyx * nyx * 4 + n * 4, 16.0 * n * nyx * nyx


def share(bound: float, seconds: float):
    """Percent of the roofline; None where nothing ran."""
    if seconds <= 0:
        return None
    return 100.0 * bound / seconds
