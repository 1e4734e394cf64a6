"""Vectorized numpy intra predictor (spec 8.4.4.2.4-8.4.4.2.6).

Used on the host recon path where per-TU sequential dependencies make tiny
device dispatches wasteful; the batched device twin is hevc_tpu_torch.ops.intra
(mode-decision sweeps). Parity: reference TComPrediction.cpp predIntraAng.
Cross-validated against the independent scalar oracle in tests/intra_oracle.py.
"""
import numpy as np

from ..core import tables


def _filter_flag(mode, size, is_luma):
    if not is_luma or size == 4 or mode == 1:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10)) if mode != 0 else 10
    return min_dist > tables.INTRA_FILTER_THRESH[tables.log2(size)]


def predict_mode(f_unfilt, f_filt, mode, size, bit_depth=8, is_luma=True,
                 smooth=None, edge_filters=True):
    """smooth: whether reference smoothing may apply (spec 8.4.4.2.3:
    cIdx == 0 or ChromaArrayType == 3); defaults to is_luma. Edge/DC
    boundary filters (8.4.4.2.5/6) remain luma-only regardless."""
    """Predict one mode from the combined ref vector f[4N+1] (layout: see
    hevc_tpu_torch.ops.intra). Returns int64 [N, N]."""
    n = size
    n2 = 2 * n
    maxval = (1 << bit_depth) - 1
    if smooth is None:
        smooth = is_luma
    f = (f_filt if _filter_flag(mode, n, smooth) else f_unfilt).astype(np.int64)
    fu = f_unfilt.astype(np.int64)
    top = f[n2 + 1:]            # p[x][-1], x in [0, 2N)
    left = f[n2 - 1::-1]        # p[-1][y], y in [0, 2N)
    corner = f[n2]
    utop = fu[n2 + 1:]
    uleft = fu[n2 - 1::-1]
    ucorner = fu[n2]

    if mode == 0:  # planar
        xs = np.arange(n, dtype=np.int64)
        pred = ((n - 1 - xs)[None, :] * left[:n, None]
                + (xs + 1)[None, :] * top[n]
                + (n - 1 - xs)[:, None] * top[None, :n]
                + (xs + 1)[:, None] * left[n]
                + n) >> (tables.log2(n) + 1)
        return pred

    if mode == 1:  # DC
        dc = (int(utop[:n].sum()) + int(uleft[:n].sum()) + n) >> (
            tables.log2(n) + 1)
        pred = np.full((n, n), dc, dtype=np.int64)
        if is_luma and n < 32:
            pred[0, 1:] = (utop[1:n] + 3 * dc + 2) >> 2
            pred[1:, 0] = (uleft[1:n] + 3 * dc + 2) >> 2
            pred[0, 0] = (uleft[0] + 2 * dc + utop[0] + 2) >> 2
        return pred

    angle = tables.intra_angle(mode)
    vertical = mode >= 18
    # main reference array ref[j], j in [-n, 2n]
    ref = np.zeros(3 * n + 1, dtype=np.int64)  # index j + n
    main = top if vertical else left
    side = left if vertical else top
    ref[n] = corner
    ref[n + 1:] = main
    if angle < 0 and ((n * angle) >> 5) < -1:
        inv = tables.intra_inv_angle(mode)
        xs = np.arange(-1, ((n * angle) >> 5) - 1, -1, dtype=np.int64)
        q = (xs * inv + 128) >> 8
        ref[xs + n] = np.where(q == 0, corner, side[np.maximum(q - 1, 0)])
    ys = np.arange(1, n + 1, dtype=np.int64)
    ii = (ys * angle) >> 5            # per main-axis index offset
    fa = (ys * angle) & 31
    xs = np.arange(n, dtype=np.int64)
    j1 = xs[None, :] + ii[:, None] + 1 + n
    r1 = ref[j1]
    r2 = ref[np.minimum(j1 + 1, 3 * n)]
    pred = np.where(fa[:, None] != 0,
                    ((32 - fa[:, None]) * r1 + fa[:, None] * r2 + 16) >> 5,
                    r1)
    if not vertical:
        pred = pred.T
    if is_luma and n < 32 and edge_filters:
        if mode == 26:
            pred[:, 0] = np.clip(utop[0] + ((uleft[:n] - ucorner) >> 1),
                                 0, maxval)
        elif mode == 10:
            pred[0, :] = np.clip(uleft[0] + ((utop[:n] - ucorner) >> 1),
                                 0, maxval)
    return pred


def predict_all_modes_np(f_unfilt, f_filt, size, bit_depth=8, is_luma=True):
    """[35, N, N] prediction sweep (host fallback of ops.intra)."""
    return np.stack([predict_mode(f_unfilt, f_filt, m, size, bit_depth,
                                  is_luma) for m in range(35)])
