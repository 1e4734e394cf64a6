"""Reproduction of the reference fork's GPU motion-estimation semantics.

Counterpart of hevc_tpu/ops/me_gpu_mode.py. The MCV-Univalle OpenCL module
computes, ONCE per 64x64 CTU at the 2Nx2N PU, a full-search SAD table for
every sub-partition geometry of the CTU, then reuses that table for every
later sub-CU/PU of the same CTU instead of running per-PU searches
(reference TEncSearch::xMotionEstimation, TEncSearch.cpp:3743-3770; the
AMP heuristic is also skipped under OpenCL, TEncCu.cpp:536). The encoder's
GPUModeME=1 runs this in the C++ engine (engine.cpp gpu_mode_compute); the
tables here are its models, which only the tests call.

Semantics modelled (reference file:line):
 * Window: anchored at the LT corner of TEncSearch::xSetSearchRange's
   clipped window around the 64x64 2Nx2N AMVP predictor
   (TEncSearch.cpp:3728,3814). The scan covers the FULL
   (2*sr+1) x (2*sr+1) offsets 0..2*sr inclusive from that corner
   (TEncOpenCL.cpp:312-333), so edge CTUs read the margin-extended plane.
 * SAD: full-pel, no row subsampling, built from per-4x4-cell SADs by a
   reduction over every partition geometry (cl/sad.cl calcSAD_AMP
   :141-367; 593 partitions with AMP, 425 without).
 * Cost: SAD + m_lambda * (golomb_bits(4*posX) + golomb_bits(4*posY))
   / 65536 in unsigned integer arithmetic, posX/posY the ABSOLUTE
   full-pel MV and m_lambda = floor(65536 * sqrt(lambda)) (cl/sad.cl
   compareSAD :370-408, TEncOpenCL.h:121 setLambda).
 * Tie-break: the FIRST minimum in raster order over (dy, dx).
 * Outputs per partition: argmin MV (absolute full-pel) and the raw SAD
   at the argmin (compareSAD :402-405).

The flat 593-entry table layout reproduces cl/sad.cl's tempSad offsets;
`part_index` computes the reference's TComDataCU::getIndexBlock
(TComDataCU.cpp:3379) from the partition list.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import runtime
from .me_exact import clip_mv_qpel, component_bits

BLOCK = 4          # 4x4 base cells (reference TypeDef.h:258 BLOCK_WIDTH)
NUM_CTU_PARTS_AMP = 593    # TypeDef.h:266 (AMP kernel, AMP_ENC_SPEEDUP=0)
NUM_CTU_PARTS = 425        # TypeDef.h:264 (non-AMP calcSAD kernel)


def _raster(w: int, h: int, ctu: int = 64):
    """Partition origins of a w x h geometry tiling the CTU, in the
    kernel's raster order (rows of partitions top to bottom)."""
    return [(x, y) for y in range(0, ctu, h) for x in range(0, ctu, w)]


@functools.lru_cache(maxsize=None)
def ctu_partitions(amp: bool = True):
    """Flat partition table [(x, y, w, h)] in the exact tempSad layout
    of cl/sad.cl calcSAD_AMP (amp=True, 593 entries) or calcSAD
    (amp=False, 425 entries)."""
    parts: list = []

    def full(w, h):
        parts.extend((x, y, w, h) for x, y in _raster(w, h))

    def amp_of(cw, ch):
        """The four AMP sub-blocks of each cw x ch CU, one class at a
        time (Up/Down for horizontal splits, Left/Right for vertical),
        matching the kernel's per-class table blocks."""
        qh, qw = ch // 4, cw // 4
        cus = _raster(cw, ch)
        out = []
        if ch >= 8:  # horizontal AMP: 2NxnU / 2NxnD
            out.append([(x, y, cw, qh) for x, y in cus])          # nU top
            out.append([(x, y + 3 * qh, cw, qh) for x, y in cus])  # nD bot
            out.append([(x, y, cw, 3 * qh) for x, y in cus])       # nU main
            out.append([(x, y + qh, cw, 3 * qh) for x, y in cus])  # nD main
        if cw >= 8:  # vertical AMP: nLx2N / nRx2N
            out.append([(x, y, qw, ch) for x, y in cus])           # nL left
            out.append([(x + 3 * qw, y, qw, ch) for x, y in cus])  # nR right
            out.append([(x, y, 3 * qw, ch) for x, y in cus])       # nL main
            out.append([(x + qw, y, 3 * qw, ch) for x, y in cus])  # nR main
        for cls in out:
            parts.extend(cls)

    if amp:
        full(8, 4)            # [0, 128)
        full(4, 8)            # [128, 256)
        amp_of(16, 16)        # 16x4 U/D, 16x12 U/D [256,320);
        #                       4x16 L/R, 12x16 L/R [320,384)
        full(8, 8)            # [384, 448)
        full(16, 8)           # [448, 480)
        full(8, 16)           # [480, 512)
        amp_of(32, 32)        # 32x8 U/D, 32x24 U/D [512,528);
        #                       8x32 L/R, 24x32 L/R [528,544)
        full(16, 16)          # [544, 560)
        full(32, 16)          # [560, 568)
        full(16, 32)          # [568, 576)
        amp_of(64, 64)        # 64x16 U/D, 64x48 U/D [576,580);
        #                       16x64 L/R, 48x64 L/R [580,584)
        full(32, 32)          # [584, 588)
        full(64, 32)          # [588, 590)
        full(32, 64)          # [590, 592)
        full(64, 64)          # [592]
        assert len(parts) == NUM_CTU_PARTS_AMP
    else:
        # calcSAD (cl/sad.cl:4-138): the symmetric geometries only
        full(8, 4)
        full(4, 8)
        full(8, 8)
        full(16, 8)
        full(8, 16)
        full(16, 16)
        full(32, 16)
        full(16, 32)
        full(32, 32)
        full(64, 32)
        full(32, 64)
        full(64, 64)
        assert len(parts) == NUM_CTU_PARTS
    return tuple(parts)


@functools.lru_cache(maxsize=None)
def _part_index_map(amp: bool = True):
    return {p: i for i, p in enumerate(ctu_partitions(amp))}


def part_index(x: int, y: int, w: int, h: int, amp: bool = True) -> int:
    """Computed replacement for TComDataCU::getIndexBlock
    (TComDataCU.cpp:3379): flat table index of the partition at CTU-
    relative (x, y) with size w x h. Raises KeyError for a geometry the
    table does not carry."""
    return _part_index_map(amp)[(x, y, w, h)]


@functools.lru_cache(maxsize=None)
def reduction_matrix(amp: bool = True) -> np.ndarray:
    """[parts, 256] 0/1 matrix summing per-4x4-cell SADs into each
    partition geometry (the matmul form of calcSAD_AMP's in-workgroup
    reduction tree; cells raster-ordered over the 16x16 cell grid)."""
    parts = ctu_partitions(amp)
    m = np.zeros((len(parts), 256), np.int32)
    for i, (x, y, w, h) in enumerate(parts):
        for cy in range(y // BLOCK, (y + h) // BLOCK):
            for cx in range(x // BLOCK, (x + w) // BLOCK):
                m[i, cy * 16 + cx] = 1
    return m


def window_lt(mvp_qpel, sr, ctu_x, ctu_y, pic_w, pic_h):
    """Full-pel LT corner of the scan window: TEncSearch::
    xSetSearchRange's clipped LT (TEncSearch.cpp:3814) as passed to
    calcMotionVectors. The scan then covers LT + [0, 2*sr]^2."""
    px, py = clip_mv_qpel(mvp_qpel, ctu_x, ctu_y, pic_w, pic_h)
    lt = clip_mv_qpel((px - (sr << 2), py - (sr << 2)),
                      ctu_x, ctu_y, pic_w, pic_h)
    return lt[0] >> 2, lt[1] >> 2


def _cell_sads_np(ctu: np.ndarray, area: np.ndarray, sr: int):
    """[2*sr+1, 2*sr+1, 256] per-position per-cell SADs. `area` is the
    (2*sr + 64)^2 search area whose (0, 0) is window offset (0, 0)."""
    n = 2 * sr + 1
    c = ctu.astype(np.int32).reshape(16, BLOCK, 16, BLOCK)
    c = c.transpose(0, 2, 1, 3).reshape(256, BLOCK, BLOCK)
    out = np.empty((n, n, 256), np.int64)
    for dy in range(n):
        for dx in range(n):
            w = area[dy:dy + 64, dx:dx + 64].astype(np.int32)
            w = w.reshape(16, BLOCK, 16, BLOCK).transpose(0, 2, 1, 3)
            out[dy, dx] = np.abs(c - w.reshape(256, BLOCK, BLOCK)) \
                .sum(axis=(1, 2))
    return out


def _rate(ltx, lty, n, lam_fp):
    """[n, n] absolute-MV rate of each scan position (compareSAD
    :376-398)."""
    bx = np.array([component_bits((ltx + d) << 2) for d in range(n)],
                  np.int64)
    by = np.array([component_bits((lty + d) << 2) for d in range(n)],
                  np.int64)
    return (lam_fp * (by[:, None] + bx[None, :])) // 65536


def gpu_mode_tables_np(ctu, ref_padded, ctu_x, ctu_y, pic_w, pic_h,
                       mvp_qpel, sr, lam_fp, amp=True):
    """Scalar model of one calcMotionVectors call: (mvx, mvy, sad) int
    arrays over the flat partition table.

    ctu:        [64, 64] original CTU samples
    ref_padded: edge-extended reference plane, symmetric pad
                >= 64 + 8 + sr (origin of the picture at (pad, pad))
    mvp_qpel:   the 64x64 2Nx2N AMVP predictor (quarter-pel)
    lam_fp:     floor(65536 * sqrt(lambda)) (TEncOpenCL::setLambda)
    """
    pad = (ref_padded.shape[1] - pic_w) // 2
    ltx, lty = window_lt(mvp_qpel, sr, ctu_x, ctu_y, pic_w, pic_h)
    aw = 2 * sr + 64
    y0 = pad + ctu_y + lty
    x0 = pad + ctu_x + ltx
    area = ref_padded[y0:y0 + aw, x0:x0 + aw]
    cells = _cell_sads_np(ctu, area, sr)                 # [n, n, 256]
    red = reduction_matrix(amp).astype(np.int64)
    sads = cells @ red.T                                 # [n, n, parts]
    n = 2 * sr + 1
    cost = sads + _rate(ltx, lty, n, lam_fp)[:, :, None]
    flat = cost.reshape(n * n, -1)
    idx = np.argmin(flat, axis=0)      # first minimum in (dy, dx) raster
    mvy = idx // n + lty
    mvx = idx % n + ltx
    sad = sads.reshape(n * n, -1)[idx, np.arange(flat.shape[1])]
    return (mvx.astype(np.int32), mvy.astype(np.int32),
            sad.astype(np.int64))


def gpu_mode_tables(ctu, ref_padded, ctu_x, ctu_y, pic_w, pic_h,
                    mvp_qpel, sr, lam_fp, amp=True, device="cuda"):
    """Device twin of gpu_mode_tables_np on `device`: per-cell SADs
    batched over positions (_cell_sads_dev), the partition reduction as
    one [positions, 256] x [256, parts] product in float64 (every sum is
    an integer below 2^53, so it is exact; a card has no integer matrix
    product), and the same raster-order first-minimum argmin."""
    dev = runtime.resolve_device(device)
    pad = (ref_padded.shape[1] - pic_w) // 2
    ltx, lty = window_lt(mvp_qpel, sr, ctu_x, ctu_y, pic_w, pic_h)
    aw = 2 * sr + 64
    y0 = pad + ctu_y + lty
    x0 = pad + ctu_x + ltx
    area = runtime.upload(np.asarray(ref_padded[y0:y0 + aw, x0:x0 + aw],
                                     np.int32), dev)
    ctu_d = runtime.upload(np.asarray(ctu, np.int32), dev)
    n = 2 * sr + 1
    cells = _cell_sads_dev(ctu_d, area, sr)              # [n*n, 256]
    red = runtime.upload(reduction_matrix(amp), dev)     # [parts, 256]
    sads = torch.matmul(cells.to(torch.float64),
                        red.to(torch.float64).T).to(torch.int64)
    cost = sads + runtime.upload(_rate(ltx, lty, n, lam_fp).reshape(-1, 1),
                                 dev)
    idx = torch.argmin(cost, dim=0)      # first minimum, raster order
    sad = torch.gather(sads, 0, idx[None])[0]
    idx, sad = idx.cpu().numpy(), sad.cpu().numpy()
    return ((idx % n + ltx).astype(np.int32),
            (idx // n + lty).astype(np.int32), sad.astype(np.int64))


def _cell_sads_dev(ctu, area, sr: int):
    """[positions, 256] int32 per-cell SADs on the device: for each row
    offset dy, the 64 x 64 windows of every column offset as one unfolded
    view of the band, cut into the 256 4x4 cells, |window - CTU| summed
    per cell."""
    n = 2 * sr + 1
    c = ctu.reshape(16, BLOCK, 16, BLOCK).permute(0, 2, 1, 3)
    c = c.reshape(256, BLOCK, BLOCK)

    def one_dy(dy):
        # [n, 64, 64]: the windows of this row at every dx
        w = area[dy:dy + 64].unfold(1, 64, 1).permute(1, 0, 2)
        w = w.reshape(n, 16, BLOCK, 16, BLOCK).permute(0, 1, 3, 2, 4)
        return (w.reshape(n, 256, BLOCK, BLOCK) - c).abs().sum(
            dim=(2, 3), dtype=torch.int32)

    return torch.stack([one_dy(dy) for dy in range(n)]).reshape(n * n, 256)
