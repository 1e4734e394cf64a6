"""Dequantization (numpy). Counterpart of the reference's
TComTrQuant.cpp xDeQuant:1314, spec 8.6.3 with the flat scaling matrix:

  dequant: c = clip16(((level * invQuantScale[qp%6] * 16) << (qp//6)
                       + (1 << (bdShift-1))) >> bdShift),
           bdShift = bitDepth + log2N - 5
"""
from __future__ import annotations

import numpy as np

from ..core import tables


ENTROPY_CODING_MIN = -32768
ENTROPY_CODING_MAX = 32767


def dequantize_np(levels: np.ndarray, size: int, qp: int,
                  bit_depth: int = 8, scaling=None) -> np.ndarray:
    qp = qp + 6 * (bit_depth - 8)   # Qp' incl. QpBdOffset (spec 8.6.1)
    log2n = tables.log2(size)
    bd_shift = bit_depth + log2n - 5
    ls = int(tables.INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    m = 16 if scaling is None else scaling.astype(np.int64)
    c = (levels.astype(np.int64) * m * ls
         + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(c, ENTROPY_CODING_MIN, ENTROPY_CODING_MAX).astype(np.int32)
