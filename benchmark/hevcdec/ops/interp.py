"""Motion-compensation interpolation filters (spec 8.5.3.3.3).

Parity: reference TComInterpolationFilter.{h,cpp} (8-tap luma / 4-tap chroma
static tap tables cpp:57-65, separable filterHor/filterVer cpp:94-392).
Host numpy path for the sequential recon; jax twin for batched search
refinement. Shifts per spec: horizontal stage >> (bitDepth-8), vertical
stage >> 6, final uni-prediction Clip((v + 32) >> (14-bitDepth))... the
combined scaling below reproduces the normative pipeline exactly for
uni-prediction at the working bit depth.
"""
from __future__ import annotations

import numpy as np

# Luma quarter-pel filters, phases 0..3 (spec Table 8-12), taps at x-3..x+4.
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# Chroma eighth-pel filters, phases 0..7 (spec Table 8-13), taps at x-1..x+2.
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)

LUMA_TAPS = 8
CHROMA_TAPS = 4


def _filter_hor(region: np.ndarray, taps: np.ndarray, w: int) -> np.ndarray:
    """Apply horizontal FIR: region [H, w + taps-1] -> [H, w], int64."""
    nt = len(taps)
    out = np.zeros((region.shape[0], w), dtype=np.int64)
    for k in range(nt):
        out += taps[k] * region[:, k:k + w].astype(np.int64)
    return out


def _filter_ver(region: np.ndarray, taps: np.ndarray, h: int) -> np.ndarray:
    nt = len(taps)
    out = np.zeros((h, region.shape[1]), dtype=np.int64)
    for k in range(nt):
        out += taps[k] * region[k:k + h].astype(np.int64)
    return out


def mc_block_np(ref: np.ndarray, pad: int, x: int, y: int, w: int, h: int,
                frac_x: int, frac_y: int, bit_depth: int = 8,
                is_luma: bool = True, raw14: bool = False) -> np.ndarray:
    """Motion-compensated prediction of a w x h block.

    `ref` is the reference plane padded by `pad` on every side (edge
    extension); (x, y) is the INTEGER-pel top-left position in unpadded
    coordinates; frac_* are the sub-pel phases (luma 0..3 quarter-pel,
    chroma 0..7 eighth-pel).

    raw14=False: clipped uni-prediction samples [h, w] int32
                 (spec 8.5.3.3.4.2: Clip((v + off) >> (14-bitDepth)))
    raw14=True:  the 14-bit intermediate predSamples (for bi averaging)
    """
    filters = LUMA_FILTERS if is_luma else CHROMA_FILTERS
    nt = LUMA_TAPS if is_luma else CHROMA_TAPS
    off = nt // 2 - 1               # taps cover [-off, nt-1-off]
    maxval = (1 << bit_depth) - 1
    # headroom floor of 2 (spec 8.5.3.3.3.2 shift1 = Min(4, BitDepth-8);
    # reference TComInterpolationFilter std::max<Int>(2, 14 - bitDepth)):
    # at 14-bit the intermediate runs at 16-bit precision, not 14
    hr = max(2, 14 - bit_depth)
    shift1 = 6 - hr                 # first filter stage down-shift
    shift_u = hr                    # uni final shift
    off_u = 1 << (shift_u - 1)
    px, py = x + pad, y + pad
    if frac_x == 0 and frac_y == 0:
        blk = ref[py:py + h, px:px + w].astype(np.int64)
        if raw14:
            return blk << shift_u   # spec: refPicLX << shift3
        return blk.astype(np.int32)
    if frac_y == 0:
        region = ref[py:py + h, px - off:px - off + w + nt - 1]
        val = _filter_hor(region, filters[frac_x], w) >> shift1
    elif frac_x == 0:
        region = ref[py - off:py - off + h + nt - 1, px:px + w]
        val = _filter_ver(region, filters[frac_y], h) >> shift1
    else:
        region = ref[py - off:py - off + h + nt - 1,
                     px - off:px - off + w + nt - 1]
        tmp = _filter_hor(region, filters[frac_x], w) >> shift1
        val = _filter_ver(tmp, filters[frac_y], h) >> 6
    if raw14:
        return val
    return np.clip((val + off_u) >> shift_u, 0, maxval).astype(np.int32)


def _mv_split(mvx: int, mvy: int, is_luma: bool, cs=1):
    """Integer offset + filter phase from a luma quarter-pel MV.
    cs = chroma subsampling shift (1 for 4:2:0, 0 for 4:4:4 where the
    chroma MV acts at quarter-pel and the 8-phase chroma filter is
    addressed at (mv & 3) << 1 — spec 8.5.3.3.3.2 SubWidthC scaling).
    A (csx, csy) pair supports 4:2:2 where only the horizontal axis is
    subsampled (eighth-pel horizontally, quarter-pel vertically)."""
    if is_luma:
        return mvx >> 2, mvx & 3, mvy >> 2, mvy & 3
    csx, csy = cs if isinstance(cs, tuple) else (cs, cs)
    shx, shy = 2 + csx, 2 + csy
    return (mvx >> shx, (mvx & ((1 << shx) - 1)) << (1 - csx),
            mvy >> shy, (mvy & ((1 << shy) - 1)) << (1 - csy))


def mc_predict_np(padded_ref: np.ndarray, pad: int, mv_qpel_x: int,
                  mv_qpel_y: int, x0: int, y0: int, w: int, h: int,
                  bit_depth: int = 8, is_luma: bool = True,
                  chroma_shift: int = 1) -> np.ndarray:
    """Prediction for a block at (x0, y0) on a pre-padded reference plane.
    The MV is in luma quarter-pel units; for chroma planes (4:2:0) the same
    MV acts at eighth-pel and (x0, y0, w, h) are chroma coordinates."""
    ix, fx, iy, fy = _mv_split(mv_qpel_x, mv_qpel_y, is_luma, chroma_shift)
    return mc_block_np(padded_ref, pad, x0 + ix, y0 + iy, w, h, fx, fy,
                       bit_depth, is_luma)


def mc_predict_wp_np(padded_ref, pad, mv_qpel_x, mv_qpel_y, x0, y0, w, h,
                     bit_depth, is_luma, wgt, off, denom,
                     chroma_shift=1):
    """Explicit weighted uni-prediction (spec 8.5.3.3.4.3): weight/offset
    applied on the 14-bit intermediate; log2Wd = denom + 14 - bitDepth."""
    ix, fx, iy, fy = _mv_split(mv_qpel_x, mv_qpel_y, is_luma, chroma_shift)
    raw = mc_block_np(padded_ref, pad, x0 + ix, y0 + iy, w, h, fx, fy,
                      bit_depth, is_luma, raw14=True)
    log2wd = denom + max(2, 14 - bit_depth)
    off = off << (bit_depth - 8)
    v = ((raw.astype(np.int64) * wgt + (1 << (log2wd - 1))) >> log2wd) + off
    return np.clip(v, 0, (1 << bit_depth) - 1).astype(np.int32)


def mc_predict_bi_np(padded0, padded1, pad, mv0, mv1, x0, y0, w, h,
                     bit_depth=8, is_luma=True, chroma_shift=1):
    """Bi-prediction: average of the two 14-bit intermediates
    (spec 8.5.3.3.4.2 default weighted: (p0 + p1 + off2) >> (15-bitDepth))."""
    def raw(padded, mv):
        ix, fx, iy, fy = _mv_split(mv[0], mv[1], is_luma, chroma_shift)
        return mc_block_np(padded, pad, x0 + ix, y0 + iy, w, h, fx, fy,
                           bit_depth, is_luma, raw14=True)
    shift2 = max(2, 14 - bit_depth) + 1
    off2 = 1 << (shift2 - 1)
    v = (raw(padded0, mv0) + raw(padded1, mv1) + off2) >> shift2
    return np.clip(v, 0, (1 << bit_depth) - 1).astype(np.int32)


def mc_predict_bi_wp_np(padded0, padded1, pad, mv0, mv1, x0, y0, w, h,
                        w0, o0, w1, o1, denom, bit_depth=8, is_luma=True,
                        chroma_shift=1):
    """Explicit weighted bi-prediction on the 14-bit intermediates
    (spec 8.5.3.3.4.3 bi-predictive case; reference
    TComWeightPrediction::addWeightBi — rounding (o0+o1+1) << log2Wd,
    shift log2Wd + 1, offsets scaled by the WpOffsetBdShift)."""
    def raw(padded, mv):
        ix, fx, iy, fy = _mv_split(mv[0], mv[1], is_luma, chroma_shift)
        return mc_block_np(padded, pad, x0 + ix, y0 + iy, w, h, fx, fy,
                           bit_depth, is_luma, raw14=True)
    hr = max(2, 14 - bit_depth)
    log2wd = denom + hr
    o0 <<= bit_depth - 8
    o1 <<= bit_depth - 8
    v = (raw(padded0, mv0).astype(np.int64) * w0
         + raw(padded1, mv1).astype(np.int64) * w1
         + ((o0 + o1 + 1) << log2wd)) >> (log2wd + 1)
    return np.clip(v, 0, (1 << bit_depth) - 1).astype(np.int32)


def pad_plane(plane: np.ndarray, pad: int) -> np.ndarray:
    """Edge-extend a reference plane (reference TComPicYuv margin extension).

    Hand-rolled instead of np.pad(mode="edge"): np.pad's generic path
    costs ~10 ms per 1080p plane; row-slice broadcasting is ~4x faster
    and this runs per reference upload on the hot frame loop."""
    h, w = plane.shape
    out = np.empty((h + 2 * pad, w + 2 * pad), plane.dtype)
    inner = out[pad:pad + h, pad:pad + w]
    inner[:] = plane
    out[pad:pad + h, :pad] = plane[:, :1]
    out[pad:pad + h, pad + w:] = plane[:, -1:]
    out[:pad] = out[pad]
    out[pad + h:] = out[pad + h - 1]
    return out
