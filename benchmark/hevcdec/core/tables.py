"""Spec-constant ROM tables, generated programmatically where possible.

Parity: reference TComRom.{h,cpp} (DCT matrices g_aiT4..32, DST matrix,
g_quantScales/g_invQuantScales, scan orders, chroma QP mapping) — all of
these are normative constants of ITU-T H.265; any conformant codec contains
the identical numbers. Instead of 32x32 literal tables we derive the DCT
matrices from the 33 distinct spec coefficients via the cosine-index folding
that defines them (verified element-wise against the normative matrices in
tests/test_transform.py's orthogonality/energy checks and by decoder
conformance).
"""
from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# Transform matrices (spec 8.6.4.2)
# ---------------------------------------------------------------------------

# v[m] ~ "64 * sqrt(2) * cos(m*pi/64)" as fixed by the spec (hand-tuned for
# orthogonality, so tabulated rather than rounded). v[0]=64 is the DC scale.
_DCT_COEF = np.array([
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0,
], dtype=np.int32)
# _DCT_COEF[m] is the magnitude used for angle m*pi/64, m in [0, 32]:
#   m= 0:64   m= 8:83(T4)   m=16:64(T4)   m=24:36(T4)
#   m= 4:89   m=12:75       m=20:50       m=28:18        (T8 odd rows)
#   m= 2:90   m= 6:87  m=10:80  m=14:70  m=18:57  m=22:43  m=26:25  m=30:9
#   m odd: 90,90,88,85,82,78,73,67,61,54,46,38,31,22,13,4  (T32 odd rows)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """The n-point HEVC core transform matrix (n in {4,8,16,32}), int32.

    Entry T[k][col] = sign * v[m] with m = fold(k*(2*col+1) * 32/n mod 128)
    folded into [0,32] by cosine symmetry.
    """
    assert n in (4, 8, 16, 32)
    t = np.zeros((n, n), dtype=np.int32)
    step = 32 // n
    for k in range(n):
        for col in range(n):
            m = (k * (2 * col + 1) * step) % 128
            s = 1
            if m > 64:
                m = 128 - m
            if m > 32:
                m = 64 - m
                s = -1
            t[k, col] = s * _DCT_COEF[m]
    return t


# 4x4 DST-VII used for 4x4 intra luma TUs (spec 8.6.4.1).
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], dtype=np.int32)

# ---------------------------------------------------------------------------
# Quantization (spec 8.6.5) — parity TComRom.h g_quantScales/g_invQuantScales
# ---------------------------------------------------------------------------

QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], np.int32)

# ---------------------------------------------------------------------------
# Chroma QP mapping for 4:2:0 (spec Table 8-10); 4:2:2/4:4:4 clip at 51.
# ---------------------------------------------------------------------------

CHROMA_QP_MAP_420 = np.array(
    list(range(30)) + [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36,
                       37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
                       48, 49, 50, 51],
    dtype=np.int32,
)

# 4:2:2 chroma intra angle remapping (spec Table 8-3): the chroma sample
# grid is stretched vertically, so the signalled direction is remapped
# before prediction and scan selection.
CHROMA_422_ANGLE_MAP = np.array(
    [0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20,
     21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31],
    dtype=np.int32,
)


def chroma_qp(qp_y: int, chroma_format: int, offset: int = 0) -> int:
    q = int(np.clip(qp_y + offset, 0, 57))
    if chroma_format == 1:  # 4:2:0
        return int(CHROMA_QP_MAP_420[q])
    return min(q, 51)


# ---------------------------------------------------------------------------
# Coefficient scan orders (spec 6.5.3/6.5.4)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def diag_scan(size: int) -> np.ndarray:
    """Up-right diagonal scan positions [(x, y), ...] for size x size block."""
    order = []
    x = y = 0
    while len(order) < size * size:
        while y >= 0:
            if x < size and y < size:
                order.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return np.array(order, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def hor_scan(size: int) -> np.ndarray:
    return np.array([(x, y) for y in range(size) for x in range(size)],
                    dtype=np.int32)


@functools.lru_cache(maxsize=None)
def ver_scan(size: int) -> np.ndarray:
    return np.array([(x, y) for x in range(size) for y in range(size)],
                    dtype=np.int32)


@functools.lru_cache(maxsize=None)
def coeff_scan(log2_size: int, scan_idx: int) -> np.ndarray:
    """Full-TU scan as flat raster indices (pos -> y*size+x), combining the
    4x4 sub-block scan with the in-sub-block scan (spec 7.3.8.11 ordering).
    For 4x4 TUs there is a single sub-block.
    """
    size = 1 << log2_size
    scans = {0: diag_scan, 1: hor_scan, 2: ver_scan}
    scan = scans[scan_idx]
    if size == 4:
        sub = scan(4)
        return (sub[:, 1] * size + sub[:, 0]).astype(np.int32)
    nsb = size // 4
    sub_blocks = scan(nsb)
    inner = scan(4)
    out = np.empty(size * size, dtype=np.int32)
    i = 0
    for sbx, sby in sub_blocks:
        for cx, cy in inner:
            x = sbx * 4 + cx
            y = sby * 4 + cy
            out[i] = y * size + x
            i += 1
    return out


# ---------------------------------------------------------------------------
# Intra prediction angle tables (spec 8.4.4.2.6)
# ---------------------------------------------------------------------------

INTRA_PRED_ANGLE = np.array([
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32,
], dtype=np.int32)  # indexed by (mode - 2), modes 2..34


def intra_angle(mode: int) -> int:
    return int(INTRA_PRED_ANGLE[mode - 2])


def intra_inv_angle(mode: int) -> int:
    a = intra_angle(mode)
    assert a < 0
    # invAngle = round(8192 / angle) reproduces the normative table exactly.
    return int(np.round(8192.0 / a))


# Thresholds for intra reference-sample smoothing (spec 8.4.4.2.3):
# min distance of mode from HOR/VER per log2 size.
INTRA_FILTER_THRESH = {3: 7, 4: 1, 5: 0}  # log2 size 8,16,32


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def log2(v: int) -> int:
    return int(v).bit_length() - 1


# Default quantization matrices (spec Table 7-5/7-6); 4x4 default is flat.
QUANT_INTRA_DEF8 = np.array([
    16, 16, 16, 16, 17, 18, 21, 24, 16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29, 16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47, 18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88, 24, 25, 29, 36, 47, 65, 88, 115,
], np.int32).reshape(8, 8)
QUANT_INTER_DEF8 = np.array([
    16, 16, 16, 16, 17, 18, 20, 24, 16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28, 16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41, 18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71, 24, 25, 28, 33, 41, 54, 71, 91,
], np.int32).reshape(8, 8)


@functools.lru_cache(maxsize=None)
def default_scaling_matrix(size: int, intra: bool):
    """Default scaling matrix for size >= 8 (8x8 upsampled to 16/32 with
    DC reset to 16); None for 4x4 (flat)."""
    if size < 8:
        return None
    base = QUANT_INTRA_DEF8 if intra else QUANT_INTER_DEF8
    m = np.repeat(np.repeat(base, size // 8, 0), size // 8, 1).copy()
    if size > 8:
        m[0, 0] = 16
    return m
