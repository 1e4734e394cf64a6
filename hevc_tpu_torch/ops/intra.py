"""Batched 35-mode intra prediction (spec 8.4.4.2) as torch tensor ops.

Counterpart of hevc_tpu/ops/intra.py (reference TComPrediction.cpp
predIntraAng:412, xPredIntraAng:250, xPredIntraPlanar:757, DC +
filterDCPred). For one TU size every mode's gather index and 5-bit
interpolation weight is a static table, so predicting all 35 modes for a
batch of TUs is one gather + weighted add on the device — the encoder's
35-mode SATD prescreen (TEncSearch::estIntraPredLumaQT:2184).

Layout: each TU carries a combined reference vector f of length 4N+1:
  f[2N]           = corner  p[-1][-1]
  f[2N + 1 + x]   = top     p[x][-1]   x in [0, 2N)
  f[2N - 1 - y]   = left    p[-1][y]   y in [0, 2N)
Two variants (unfiltered, [1 2 1]-filtered) are stacked; each mode statically
selects its variant per the smoothing rules (8.4.4.2.3).

The host helpers below the device code (reference-sample filtering and the
strong-smoothing test) are numpy, used by the sequential intra encoder.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import runtime
from ..core import tables
from ..core.types import IntraMode

NUM_MODES = 35


def _filter_flag(mode: int, size: int, is_luma: bool) -> bool:
    """Spec 8.4.4.2.3 reference-sample smoothing decision."""
    if not is_luma or size == 4 or mode == IntraMode.DC:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10)) if mode != 0 else 10
    if mode == 0:
        min_dist = min(abs(0 - 26), abs(0 - 10))  # planar treated as mode 0
    thresh = tables.INTRA_FILTER_THRESH[tables.log2(size)]
    return min_dist > thresh


def _main_ref_index(mode: int, size: int, j: int) -> int:
    """Index into the combined ref vector f for main-reference position j
    (j in [-N, 2N]) of angular `mode` (spec 8.4.4.2.6 ref[] construction)."""
    n2 = 2 * size
    vertical = mode >= 18
    if j >= 0:
        return n2 + j if vertical else n2 - j
    if tables.intra_angle(mode) >= 0:
        return n2  # unreachable for positive angles; point at corner
    inv = tables.intra_inv_angle(mode)
    step = (j * inv + 128) >> 8
    idx = n2 - step if vertical else n2 + step
    # j values outside the mode's actual reach are never gathered; clamp so
    # the precomputed table stays in-bounds anyway.
    return min(max(idx, 0), 4 * size)


@functools.lru_cache(maxsize=None)
def _angular_tables(size: int, is_luma: bool):
    """Static per-size gather tables for modes 2..34.

    Returns (idx1, idx2, frac) each of shape [33, N, N] — indices into the
    stacked [2, 4N+1] reference (flattened), frac in [0, 32).
    Horizontal modes (<18) are built transposed so one formula serves both.
    """
    n = size
    reflen = 4 * n + 1
    idx1 = np.zeros((33, n, n), np.int32)
    idx2 = np.zeros((33, n, n), np.int32)
    frac = np.zeros((33, n, n), np.int32)
    for mode in range(2, 35):
        angle = tables.intra_angle(mode)
        variant = 1 if _filter_flag(mode, size, is_luma) else 0
        base = variant * reflen
        g = {j: base + _main_ref_index(mode, size, j)
             for j in range(-n, 2 * n + 1)}
        vertical = mode >= 18
        for yy in range(n):       # main-axis offset driver
            i_idx = ((yy + 1) * angle) >> 5
            i_fact = ((yy + 1) * angle) & 31
            for xx in range(n):   # along the prediction row
                j1 = xx + i_idx + 1
                j2 = min(j1 + 1, 2 * n)
                # output position: vertical modes index [y][x]; horizontal
                # modes are the transpose.
                oy, ox = (yy, xx) if vertical else (xx, yy)
                idx1[mode - 2, oy, ox] = g[j1]
                idx2[mode - 2, oy, ox] = g[j2]
                frac[mode - 2, oy, ox] = i_fact
    return idx1, idx2, frac


@functools.lru_cache(maxsize=None)
def _angular_tables_dev(size: int, is_luma: bool, device: torch.device):
    """The angular gather tables on the device (flattened idx1, idx2 as
    int64; frac int32 [33, N, N]), uploaded once per size and device."""
    idx1, idx2, frac = _angular_tables(size, is_luma)
    return (runtime.upload(idx1.reshape(-1).astype(np.int64), device),
            runtime.upload(idx2.reshape(-1).astype(np.int64), device),
            runtime.upload(frac, device))


def predict_all_modes(ref_unfilt: torch.Tensor, ref_filt: torch.Tensor, *,
                      size: int, bit_depth: int = 8,
                      is_luma: bool = True) -> torch.Tensor:
    """ref_unfilt/ref_filt: int32 [B, 4N+1] -> predictions [B, 35, N, N]."""
    n = size
    log2n = tables.log2(n)
    b = ref_unfilt.shape[0]
    maxval = (1 << bit_depth) - 1
    dev = ref_unfilt.device
    refs = torch.cat([ref_unfilt, ref_filt], dim=-1)   # [B, 2*(4N+1)]

    # --- angular modes 2..34: one gather -----------------------------------
    idx1, idx2, frac = _angular_tables_dev(n, is_luma, dev)
    r1 = refs.index_select(1, idx1).reshape(b, 33, n, n)
    r2 = refs.index_select(1, idx2).reshape(b, 33, n, n)
    f = frac[None]
    ang = ((32 - f) * r1 + f * r2 + 16) >> 5

    # named slices of the unfiltered ref
    n2 = 2 * n
    corner = ref_unfilt[:, n2]
    top = ref_unfilt[:, n2 + 1: n2 + 1 + n]                  # p[0..N-1][-1]
    left = ref_unfilt[:, n2 - n: n2].flip(-1)                # p[-1][0..N-1]

    # --- planar (8.4.4.2.4), uses the filtered variant when smoothing on ---
    pref = ref_filt if _filter_flag(0, n, is_luma) else ref_unfilt
    p_top = pref[:, n2 + 1: n2 + 1 + n]
    p_left = pref[:, n2 - n: n2].flip(-1)
    p_tr = pref[:, n2 + 1 + n]                                # p[N][-1]
    p_bl = pref[:, n2 - 1 - n]                                # p[-1][N]
    xs = torch.arange(n, dtype=torch.int32, device=dev)
    planar = ((n - 1 - xs)[None, None, :] * p_left[:, :, None]
              + (xs + 1)[None, None, :] * p_tr[:, None, None]
              + (n - 1 - xs)[None, :, None] * p_top[:, None, :]
              + (xs + 1)[None, :, None] * p_bl[:, None, None]
              + n) >> (log2n + 1)

    # --- DC (8.4.4.2.5) -----------------------------------------------------
    dc = (top.sum(-1, dtype=torch.int32) + left.sum(-1, dtype=torch.int32)
          + n) >> (log2n + 1)
    dcp = dc[:, None, None].expand(b, n, n).clone()
    if is_luma and n < 32:
        dcp[:, 0, :] = (top + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (left + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2

    # --- pure hor/ver boundary compensation (luma, N<32) -------------------
    if is_luma and n < 32:
        # mode 26 (vertical): first column adjusted towards the left edge
        ang[:, 26 - 2, :, 0] = torch.clamp(
            top[:, 0:1] + ((left - corner[:, None]) >> 1), 0, maxval)
        # mode 10 (horizontal): first row adjusted towards the top edge
        ang[:, 10 - 2, 0, :] = torch.clamp(
            left[:, 0:1] + ((top - corner[:, None]) >> 1), 0, maxval)

    return torch.cat([planar[:, None], dcp[:, None], ang], dim=1)


# ---------------------------------------------------------------------------
# Reference-sample construction (host/numpy: per-TU sequential bookkeeping)
# ---------------------------------------------------------------------------

# Reference-vector construction with normative availability/substitution
# lives in hevc_tpu.core.refsamples (shared by encoder and decoder).


def filter_ref_samples(f: np.ndarray, size: int, bit_depth: int = 8,
                       strong_smoothing: bool = False) -> np.ndarray:
    """[1 2 1]/4 smoothing of the combined ref vector (spec 8.4.4.2.3).

    With `strong_smoothing` (nTbS==32 and the bi-linearity test passed),
    linear interpolation between the corners replaces the FIR filter.
    """
    n = size
    n2 = 2 * n
    out = f.astype(np.int32).copy()
    if strong_smoothing and n == 32:
        corner = int(f[n2])
        top_end = int(f[n2 + 2 * n])
        left_end = int(f[n2 - 2 * n])
        for x in range(1, 2 * n):
            out[n2 + x] = ((2 * n - x) * corner + x * top_end + n) >> (
                tables.log2(n) + 1)
            out[n2 - x] = ((2 * n - x) * corner + x * left_end + n) >> (
                tables.log2(n) + 1)
        return out
    # ends copied, interior smoothed
    out[1:-1] = (f[:-2].astype(np.int32) + 2 * f[1:-1] + f[2:] + 2) >> 2
    return out


def strong_smoothing_decision(f: np.ndarray, size: int,
                              bit_depth: int = 8) -> bool:
    """Spec 8.4.4.2.3 bi-linearity test for 32x32 strong smoothing."""
    if size != 32:
        return False
    n2 = 2 * size
    thresh = 1 << (bit_depth - 5)
    corner = int(f[n2])
    top_mid, top_end = int(f[n2 + size]), int(f[n2 + 2 * size])
    left_mid, left_end = int(f[n2 - size]), int(f[n2 - 2 * size])
    return (abs(corner + top_end - 2 * top_mid) < thresh
            and abs(corner + left_end - 2 * left_mid) < thresh)
