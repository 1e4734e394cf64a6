"""HM-exact integer full search (the reference's GPU-vs-CPU validation
pattern).

Counterpart of hevc_tpu/ops/me_exact.py. Parity: reference
TEncSearch::xPatternSearch (TEncSearch.cpp:3835-3890) — raster full search
over the window TEncSearch::xSetSearchRange centres on the CLIPPED motion
predictor (TComDataCU::clipMv margins), SAD distortion with the
fast-encoder row subsampling (rows > 8 -> every second row, doubled),
motion cost (lambdaSAD * golombBits((mv << 2) - mvpQpel)) >> 16 at cost
scale 2, and the FIRST-minimum tie-break (strict '<', y-outer/x-inner
raster order).

`hm_full_search` (batched torch on a device) must equal
`hm_full_search_np` (a literal transliteration of the reference). No
encoder path calls either; the tests do, and hold both to hevc_tpu's.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import runtime


def component_bits(v: int) -> int:
    """Golomb bit count of one MV component difference (reference
    TComRdCost::xGetComponentBits, TComRdCost.cpp:278)."""
    t = (-v << 1) + 1 if v <= 0 else (v << 1)
    length = 1
    while t != 1:
        t >>= 1
        length += 2
    return length


def clip_mv_qpel(mv, cu_x, cu_y, pic_w, pic_h, max_cu=64):
    """Reference TComDataCU::clipMv (TComDataCU.cpp:2907): quarter-pel
    clamp to picture + 8-sample margin relative to the CU origin."""
    hor_max = (pic_w + 8 - cu_x - 1) << 2
    hor_min = (-max_cu - 8 - cu_x + 1) << 2
    ver_max = (pic_h + 8 - cu_y - 1) << 2
    ver_min = (-max_cu - 8 - cu_y + 1) << 2
    return (min(hor_max, max(hor_min, mv[0])),
            min(ver_max, max(ver_min, mv[1])))


def search_window(mvp_qpel, sr, cu_x, cu_y, pic_w, pic_h, max_cu=64):
    """Full-pel window bounds (lo_x, lo_y, hi_x, hi_y) exactly as
    TEncSearch::xSetSearchRange derives them: the window is centred on
    the CLIPPED predictor, extended by +-sr, clipped again, then >> 2
    (arithmetic shift — Python's floor >> matches gcc)."""
    px, py = clip_mv_qpel(mvp_qpel, cu_x, cu_y, pic_w, pic_h, max_cu)
    lt = clip_mv_qpel((px - (sr << 2), py - (sr << 2)),
                      cu_x, cu_y, pic_w, pic_h, max_cu)
    rb = clip_mv_qpel((px + (sr << 2), py + (sr << 2)),
                      cu_x, cu_y, pic_w, pic_h, max_cu)
    return lt[0] >> 2, lt[1] >> 2, rb[0] >> 2, rb[1] >> 2


def hm_full_search_np(block: np.ndarray, ref: np.ndarray, cx: int, cy: int,
                      mvp_qpel, lambda_sad_16: int, sr: int,
                      pic_w: int, pic_h: int, fast_sub: bool = True):
    """Literal reference-semantics search. `ref` is an edge-extended
    plane with symmetric pad >= max_cu + 8 + sr overshoot; (cx, cy) is
    the PU (== CU for 2Nx2N) origin in unpadded coords. Returns
    (mvx, mvy, sad) in full-pel."""
    n_h, n_w = block.shape
    pad = (ref.shape[1] - pic_w) // 2
    lo_x, lo_y, hi_x, hi_y = search_window(
        mvp_qpel, sr, cx, cy, pic_w, pic_h)
    sub = 2 if (fast_sub and n_h > 8) else 1
    best = None
    blk = block.astype(np.int64)[::sub]
    for y in range(lo_y, hi_y + 1):
        for x in range(lo_x, hi_x + 1):
            win = ref[pad + cy + y:pad + cy + y + n_h,
                      pad + cx + x:pad + cx + x + n_w].astype(np.int64)
            sad = int(np.abs(blk - win[::sub]).sum()) << (sub >> 1)
            cost = sad + ((lambda_sad_16 *
                           (component_bits((x << 2) - mvp_qpel[0])
                            + component_bits((y << 2) - mvp_qpel[1])))
                          >> 16)
            if best is None or cost < best[0]:
                best = (cost, x, y, sad)
    return best[1], best[2], best[3]


def _mv_cost_grid(rng_x, rng_y, mvp_qpel, lambda_sad_16):
    bits_x = np.array([component_bits((x << 2) - mvp_qpel[0])
                       for x in rng_x], np.int64)
    bits_y = np.array([component_bits((y << 2) - mvp_qpel[1])
                       for y in rng_y], np.int64)
    return (lambda_sad_16 * (bits_y[:, None] + bits_x[None, :])) >> 16


def hm_full_search(block, ref, cx: int, cy: int, mvp_qpel,
                   lambda_sad_16: int, sr: int, pic_w: int, pic_h: int,
                   fast_sub: bool = True, device="cuda"):
    """Device twin of `hm_full_search_np`: the SAD grid of the whole
    window built on `device` (every window of a row of offsets as one
    unfolded view, int64 sums), and the first minimum over the
    raster-ordered flat grid (torch.argmin returns the first), which is
    the reference's tie-break."""
    dev = runtime.resolve_device(device)
    n_h, n_w = block.shape
    pad = (ref.shape[1] - pic_w) // 2
    lo_x, lo_y, hi_x, hi_y = search_window(
        mvp_qpel, sr, cx, cy, pic_w, pic_h)
    rng_x = np.arange(lo_x, hi_x + 1)
    rng_y = np.arange(lo_y, hi_y + 1)
    sub = 2 if (fast_sub and n_h > 8) else 1
    region = runtime.upload(np.asarray(
        ref[pad + cy + lo_y:pad + cy + hi_y + n_h,
            pad + cx + lo_x:pad + cx + hi_x + n_w], np.int64), dev)
    blk = runtime.upload(np.asarray(block, np.int64)[::sub], dev)
    # [rows of offsets, columns of offsets, n_h, n_w] windows, a view
    wins = region.unfold(0, n_h, 1).unfold(1, n_w, 1)
    sads = torch.stack([(wins[dy, :, ::sub] - blk).abs().sum(dim=(1, 2))
                        for dy in range(len(rng_y))]) << (sub >> 1)
    cost = sads + runtime.upload(
        _mv_cost_grid(rng_x, rng_y, mvp_qpel, lambda_sad_16), dev)
    idx = int(torch.argmin(cost.reshape(-1)))   # first minimum (raster)
    by, bx = divmod(idx, len(rng_x))
    return (int(rng_x[bx]), int(rng_y[by]), int(sads[by, bx]))
