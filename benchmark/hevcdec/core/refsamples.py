"""Intra reference-sample fetch + substitution (spec 8.4.4.2.2).

Shared by encoder and decoder so both derive bit-identical predictions.
Parity: reference TComPattern.cpp initIntraPatternChType / fillReferenceSamples
— vectorized: samples are fetched with numpy slices and availability is
evaluated once per 4x4-luma min block (the normative granularity), then the
substitution scan is a vectorized forward fill.

Combined reference vector layout f[0..4N] (see hevc_tpu_torch.ops.intra):
  f[i], i in [0, 2N)  : left column, f[2N-1-y] = p[-1][y], y in [0, 2N)
  f[2N]               : corner p[-1][-1]
  f[2N+1+x]           : top row p[x][-1], x in [0, 2N)
"""
from __future__ import annotations

import numpy as np

from .geometry import AvailabilityMap


def build_ref_vector(plane: np.ndarray, x0: int, y0: int, size: int,
                     avail: AvailabilityMap, bit_depth: int,
                     luma_pos=None, cip_mask=None) -> np.ndarray:
    """Reference vector for the TU at (x0, y0) of `size` on `plane`.

    `plane` is the working reconstruction at this component's resolution.
    Availability is decided in LUMA coordinates: for chroma planes pass
    `luma_pos = (luma_x0, luma_y0, scale_x, scale_y)` (spec 6.4.1 operates
    on luma locations; chroma availability mirrors the collocated luma).

    `cip_mask`: constrained intra prediction (PPS
    constrained_intra_pred_flag; spec 8.4.4.2.2, reference TComPattern
    fillReferenceSamples constrained branch) — a bool array at 4x4 LUMA
    granularity, True where the block was intra-coded; inter neighbour
    samples are treated unavailable and substituted.
    """
    n = size
    n2 = 2 * n
    nn = 4 * n + 1
    f = np.zeros(nn, dtype=np.int32)
    have = np.zeros(nn, dtype=bool)
    h, w = plane.shape

    if luma_pos is None:
        lx0, ly0, sx, sy = x0, y0, 1, 1
    else:
        lx0, ly0, sx, sy = luma_pos
    chunk_y = max(1, 4 // sy)   # availability granularity in component rows
    chunk_x = max(1, 4 // sx)

    def usable(lx: int, ly: int) -> bool:
        if not avail.is_available(lx, ly, lx0, ly0):
            return False
        return cip_mask is None or bool(cip_mask[ly >> 2, lx >> 2])

    # ---- left column (incl. below-left): f[2N-1-y] = p[-1][y] ----
    if x0 > 0:
        ylim = min(2 * n, h - y0)
        col = plane[y0:y0 + ylim, x0 - 1].astype(np.int32)
        ok = np.zeros(ylim, dtype=bool)
        for yc in range(0, ylim, chunk_y):
            if usable(lx0 - 1, ly0 + yc * sy):
                ok[yc:yc + chunk_y] = True
        dst = np.arange(ylim)
        f[n2 - 1 - dst] = col
        have[n2 - 1 - dst] = ok
    # ---- corner ----
    if x0 > 0 and y0 > 0 and usable(lx0 - 1, ly0 - 1):
        f[n2] = plane[y0 - 1, x0 - 1]
        have[n2] = True
    # ---- top row (incl. above-right): f[2N+1+x] = p[x][-1] ----
    if y0 > 0:
        xlim = min(2 * n, w - x0)
        row = plane[y0 - 1, x0:x0 + xlim].astype(np.int32)
        ok = np.zeros(xlim, dtype=bool)
        for xc in range(0, xlim, chunk_x):
            if usable(lx0 + xc * sx, ly0 - 1):
                ok[xc:xc + chunk_x] = True
        f[n2 + 1:n2 + 1 + xlim] = row
        have[n2 + 1:n2 + 1 + xlim] = ok

    # ---- substitution (8.4.4.2.2): forward fill from the first available --
    if not have.any():
        f[:] = 1 << (bit_depth - 1)
        return f
    if not have[0]:
        f[0] = f[int(np.argmax(have))]
        have[0] = True
    idx = np.where(have, np.arange(nn), 0)
    np.maximum.accumulate(idx, out=idx)
    return f[idx]
