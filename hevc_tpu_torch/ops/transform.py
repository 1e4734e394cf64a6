"""Forward/inverse core transforms as batched integer matrix products.

Counterpart of hevc_tpu/ops/transform.py (reference TComTrQuant.cpp
partialButterfly{4,8,16,32}(+Inverse) :388-859 and
fastForwardDst/fastInverseDst :414-474): the numpy twins the host encoders
use, and the device versions (`forward_transform`, `inverse_transform`,
batched over any leading axes on a torch device), which only the tests
call. A card has no integer matrix product, so the device versions
multiply in float64: every product and sum is an integer below 2^53, so
the result is exact, and the rounding shifts run on int64.

Shifts per spec 8.6.4:
  forward: stage1 >> (log2N + bitDepth - 9), stage2 >> (log2N + 6)
  inverse: stage1 >> 7 (clip to 16-bit), stage2 >> (20 - bitDepth)
"""
from __future__ import annotations

import numpy as np
import torch

from .. import runtime
from ..core import tables

MAX_TR_DYNAMIC_RANGE = 15  # reference TypeDef.h maxTrDynamicRange (non-RExt)


def _matrix(size: int, is_dst: bool) -> np.ndarray:
    if is_dst:
        assert size == 4
        return tables.DST4
    return tables.dct_matrix(size)


def _rshift_round(x: torch.Tensor, shift: int) -> torch.Tensor:
    return (x + (1 << (shift - 1))) >> shift


def _matrix_dev(size: int, is_dst: bool, dev) -> torch.Tensor:
    return runtime.upload(_matrix(size, is_dst).astype(np.float64), dev)


def forward_transform(residual, *, size: int, bit_depth: int = 8,
                      is_dst: bool = False, device="cuda") -> torch.Tensor:
    """residual [..., size, size] (array or tensor) -> coefficients int32
    [..., size, size] on `device`: stage 1 horizontal, tmp[j, k] =
    sum_n r[j, n] T[k, n] >> (log2N + bitDepth - 9); stage 2 vertical,
    out[k, l] = sum_j T[k, j] tmp[j, l] >> (log2N + 6)."""
    dev = runtime.resolve_device(device)
    t = _matrix_dev(size, is_dst, dev)
    log2n = tables.log2(size)
    r = torch.as_tensor(residual).to(dev, torch.float64)
    tmp = _rshift_round(torch.matmul(r, t.T).to(torch.int64),
                        log2n + bit_depth - 9)
    out = torch.matmul(t, tmp.to(torch.float64)).to(torch.int64)
    return _rshift_round(out, log2n + 6).to(torch.int32)


def inverse_transform(coeffs, *, size: int, bit_depth: int = 8,
                      is_dst: bool = False, device="cuda") -> torch.Tensor:
    """coeffs [..., size, size] -> residual int32 [..., size, size] on
    `device`: stage 1 T^T c >> 7 clipped to 16 bits (normative), stage 2
    tmp T >> (20 - bitDepth), clipped to 16 bits below 15 bits (the
    reference's Pel protection, not normative)."""
    dev = runtime.resolve_device(device)
    t = _matrix_dev(size, is_dst, dev)
    c = torch.as_tensor(coeffs).to(dev, torch.float64)
    tmp = _rshift_round(torch.matmul(t.T, c).to(torch.int64), 7)
    tmp = tmp.clamp(-32768, 32767)
    out = _rshift_round(torch.matmul(tmp.to(torch.float64), t)
                        .to(torch.int64), 20 - bit_depth)
    if bit_depth <= 14:
        out = out.clamp(-32768, 32767)
    return out.to(torch.int32)


def forward_transform_np(residual: np.ndarray, size: int, bit_depth: int = 8,
                         is_dst: bool = False) -> np.ndarray:
    t = _matrix(size, is_dst).astype(np.int64)
    log2n = tables.log2(size)
    shift1 = log2n + bit_depth - 9
    shift2 = log2n + 6
    tmp = (residual.astype(np.int64) @ t.T + (1 << (shift1 - 1))) >> shift1
    out = (t @ tmp + (1 << (shift2 - 1))) >> shift2
    return out.astype(np.int32)


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
