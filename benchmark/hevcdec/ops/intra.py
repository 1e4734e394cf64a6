"""Intra reference-sample filtering (spec 8.4.4.2.3, numpy): the [1 2 1]
smoothing and the strong-smoothing test of 32x32 blocks."""
from __future__ import annotations

import numpy as np

from ..core import tables


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
