"""Inverse core transforms as integer matrix products (numpy).

Counterpart of the reference's TComTrQuant.cpp partialButterflyInverse
and fastInverseDst. Shifts per spec 8.6.4: stage1 >> 7 (clip to 16-bit),
stage2 >> (20 - bitDepth).
"""
from __future__ import annotations

import numpy as np

from ..core import tables


MAX_TR_DYNAMIC_RANGE = 15  # reference TypeDef.h maxTrDynamicRange (non-RExt)


def _matrix(size: int, is_dst: bool) -> np.ndarray:
    if is_dst:
        assert size == 4
        return tables.DST4
    return tables.dct_matrix(size)


def inverse_transform_np(coeffs: np.ndarray, size: int, bit_depth: int = 8,
                         is_dst: bool = False) -> np.ndarray:
    t = _matrix(size, is_dst).astype(np.int64)
    shift2 = 20 - bit_depth
    tmp = (t.T @ coeffs.astype(np.int64) + 64) >> 7
    tmp = np.clip(tmp, -32768, 32767)
    out = (tmp @ t + (1 << (shift2 - 1))) >> shift2
    if bit_depth > 14:
        return out.astype(np.int32)  # HBD: Pel-protection clip is a no-op
    return np.clip(out, -32768, 32767).astype(np.int32)


def inverse_ts_np(deq: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """Transform-skip inverse (spec 8.6.4.2 r = d << 7 followed by the
    8.6.5 bdShift = 20 - BitDepth rounding; reference
    TComTrQuant::xITransformSkip)."""
    bd_shift = 20 - bit_depth
    rnd = 1 << (bd_shift - 1)
    return ((deq.astype(np.int64) << 7) + rnd) >> bd_shift
