"""Quantization / dequantization: numpy twins and device versions.

Counterpart of hevc_tpu/ops/quant.py (reference TComTrQuant.cpp
xQuant:1126 with HM's rounding-offset scheme, 171/256 intra and 85/256
inter, and xDeQuant:1314, spec 8.6.3 with the flat scaling matrix). The
numpy twins serve the host encoders; the device versions (`quantize`,
`dequantize`, elementwise int32 on a torch device, as the reference's)
only the tests call.

  transformShift = 15 - bitDepth - log2N
  forward: level = sign * ((|c| * quantScale[qp%6] + offset) >> qBits),
           qBits = 14 + qp//6 + transformShift
  dequant: c = clip16(((level * invQuantScale[qp%6] * 16) << (qp//6)
                       + (1 << (bdShift-1))) >> bdShift),
           bdShift = bitDepth + log2N - 5
"""
from __future__ import annotations

import numpy as np
import torch

from .. import runtime
from ..core import tables

ENTROPY_CODING_MIN = -32768
ENTROPY_CODING_MAX = 32767


def quantize(coeffs, *, size: int, qp: int, bit_depth: int = 8,
             is_intra: bool = True, device="cuda") -> torch.Tensor:
    """Levels int32 of coefficients [...] (array or tensor) on `device`.
    |c| <= 32767 and scale <= 26214, so |c| * scale + offset < 2^31: the
    int32 arithmetic of the reference is exact."""
    qp = qp + 6 * (bit_depth - 8)   # Qp' incl. QpBdOffset (spec 8.6.1)
    log2n = tables.log2(size)
    qbits = 14 + qp // 6 + 15 - bit_depth - log2n
    scale = int(tables.QUANT_SCALES[qp % 6])
    offset = (171 if is_intra else 85) << (qbits - 9)
    c = torch.as_tensor(coeffs).to(runtime.resolve_device(device),
                                   torch.int32)
    level = ((c.abs() * scale + offset) >> qbits).clamp(0,
                                                        ENTROPY_CODING_MAX)
    return torch.where(c < 0, -level, level)


def dequantize(levels, *, size: int, qp: int, bit_depth: int = 8,
               device="cuda") -> torch.Tensor:
    """Coefficients int32 of levels [...] on `device`. As in the
    reference, the spec's (level * 16 * scale) << (qp // 6) is folded
    into one shift, so that the products stay below 2^22 (int32)."""
    qp = qp + 6 * (bit_depth - 8)   # Qp' incl. QpBdOffset (spec 8.6.1)
    bd_shift = bit_depth + tables.log2(size) - 5
    scale = int(tables.INV_QUANT_SCALES[qp % 6])
    rshift = bd_shift - 4 - qp // 6
    c = torch.as_tensor(levels).to(runtime.resolve_device(device),
                                   torch.int32) * scale
    if rshift > 0:
        c = (c + (1 << (rshift - 1))) >> rshift
    else:
        c = c << -rshift
    return c.clamp(ENTROPY_CODING_MIN, ENTROPY_CODING_MAX)


def quantize_np(coeffs: np.ndarray, size: int, qp: int, bit_depth: int = 8,
                is_intra: bool = True, scaling=None) -> np.ndarray:
    """scaling: per-coefficient scaling matrix (spec 8.6.3 m[x][y]); the
    forward quant scale folds it as (quantScale << 4) / m, matching the
    reference TComTrQuant::xSetScalingListEnc quantCoef derivation."""
    qp = qp + 6 * (bit_depth - 8)   # Qp' incl. QpBdOffset (spec 8.6.1)
    log2n = tables.log2(size)
    transform_shift = 15 - bit_depth - log2n
    qbits = 14 + qp // 6 + transform_shift
    scale = int(tables.QUANT_SCALES[qp % 6])
    if scaling is not None:
        scale = (scale << 4) // scaling.astype(np.int64)
    offset = (171 if is_intra else 85) << (qbits - 9)
    c = coeffs.astype(np.int64)
    level = (np.abs(c) * scale + offset) >> qbits
    level = np.clip(level, 0, ENTROPY_CODING_MAX)
    return np.where(c < 0, -level, level).astype(np.int32)


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
