"""Sample Adaptive Offset: application + encoder estimation (spec 8.7.3).

Parity: reference TComSampleAdaptiveOffset.{h,cpp} (offsetBlock:313,
SAOProcess:614) and TEncSampleAdaptiveOffset (statistics getStatistics:309,
deriveOffsets:473). Application and classification are fully vectorized
over the frame; per-CTU parameters select the offsets.

Shared by encoder and decoder: SAO input is the DEBLOCKED picture; output
samples only read unfiltered (deblocked) neighbours, so the whole frame is
one functional pass.
"""
from __future__ import annotations

from typing import List

import numpy as np

# neighbour offsets per EO class: (n0, n1)
EO_NEIGHBOURS = {
    0: ((0, -1), (0, 1)),     # horizontal
    1: ((-1, 0), (1, 0)),     # vertical
    2: ((-1, -1), (1, 1)),    # 135 degrees
    3: ((-1, 1), (1, -1)),    # 45 degrees
}
EDGE_IDX_MAP = np.array([1, 2, 0, 3, 4], np.int32)  # spec 8.7.3 Map


def _edge_categories(plane: np.ndarray, eo_class: int) -> np.ndarray:
    """Per-sample edge category 0..4 (0 = no offset); boundary samples that
    would read outside the picture get category 0."""
    p = plane.astype(np.int32)
    (dy0, dx0), (dy1, dx1) = EO_NEIGHBOURS[eo_class]
    pad = np.pad(p, 1, mode="edge")
    n0 = pad[1 + dy0:1 + dy0 + p.shape[0], 1 + dx0:1 + dx0 + p.shape[1]]
    n1 = pad[1 + dy1:1 + dy1 + p.shape[0], 1 + dx1:1 + dx1 + p.shape[1]]
    cat = EDGE_IDX_MAP[2 + np.sign(p - n0) + np.sign(p - n1)]
    # samples whose neighbours fall outside the picture: no offset
    mask = np.ones_like(cat, bool)
    if dx0 == -1 or dx1 == -1:
        mask[:, 0] = False
    if dx0 == 1 or dx1 == 1:
        mask[:, -1] = False
    if dy0 == -1 or dy1 == -1:
        mask[0, :] = False
    if dy0 == 1 or dy1 == 1:
        mask[-1, :] = False
    return np.where(mask, cat, 0)


def apply_sao(deblocked: List[np.ndarray], sao_params: List[np.ndarray],
              sps, bit_depth: int) -> List[np.ndarray]:
    """Apply per-CTU SAO parameters (layout: entropy CtuData.sao) to the
    deblocked planes; returns new planes."""
    ctu = sps.ctu_size
    w = sps.pic_width_in_luma_samples
    h = sps.pic_height_in_luma_samples
    ctus_w = -(-w // ctu)
    maxv = (1 << bit_depth) - 1
    shift = bit_depth - 5
    out = [p.copy() for p in deblocked]
    # resolve merges (type 7 slot: 1=left, 2=up) into concrete params
    resolved = []
    for i, prm in enumerate(sao_params):
        prm = prm.copy()
        resolved.append(prm)

    # per-class cached category maps (computed lazily per component)
    cat_cache = [{}, {}, {}]

    def cats(ci, klass):
        if klass not in cat_cache[ci]:
            cat_cache[ci][klass] = _edge_categories(deblocked[ci], klass)
        return cat_cache[ci][klass]

    for i, prm in enumerate(resolved):
        cy, cx = divmod(i, ctus_w)
        for ci in range(3):
            t = prm[0] if ci == 0 else prm[1]
            if t == 0:
                continue
            sx = 1 if ci == 0 else 1 << sps.chroma_shift_x
            sy = 1 if ci == 0 else 1 << sps.chroma_shift_y
            x0, y0 = (cx * ctu) // sx, (cy * ctu) // sy
            x1 = min(((cx + 1) * ctu) // sx, w // sx)
            y1 = min(((cy + 1) * ctu) // sy, h // sy)
            off = prm[8 + 4 * ci:12 + 4 * ci]
            reg = deblocked[ci][y0:y1, x0:x1].astype(np.int32)
            if t == 2:  # edge
                klass = prm[2] if ci == 0 else prm[3]
                c = cats(ci, int(klass))[y0:y1, x0:x1]
                offs = np.zeros(5, np.int32)
                offs[1:5] = off
                reg = reg + offs[c]
            else:  # band
                pos = prm[4 + ci]
                band = reg >> shift
                offs = np.zeros(32, np.int32)
                for k in range(4):
                    offs[(pos + k) & 31] = off[k]
                reg = reg + offs[band]
            out[ci][y0:y1, x0:x1] = np.clip(reg, 0, maxv).astype(
                out[ci].dtype)
    return out


def estimate_sao(orig: List[np.ndarray], deblocked: List[np.ndarray],
                 sps, bit_depth: int, lam: float) -> List[np.ndarray]:
    """Per-CTU SAO parameter estimation: for each component try OFF, the 4
    EO classes and BO; pick minimum SSE-delta + lambda*bits. Chroma shares
    one type/eo-class (picked jointly for cb+cr, spec constraint)."""
    ctu = sps.ctu_size
    w = sps.pic_width_in_luma_samples
    h = sps.pic_height_in_luma_samples
    ctus_w = -(-w // ctu)
    ctus_h = -(-h // ctu)
    shift = bit_depth - 5
    max_off = (1 << (min(bit_depth, 10) - 5)) - 1

    diffs = [o.astype(np.int64) - d.astype(np.int64)
             for o, d in zip(orig, deblocked)]
    cat_maps = [[_edge_categories(deblocked[ci], k) for k in range(4)]
                for ci in range(3)]
    band_maps = [deblocked[ci].astype(np.int32) >> shift for ci in range(3)]

    def best_offset(E, N, lo, hi):
        if N == 0:
            return 0, 0
        o = int(np.clip(round(E / N), lo, hi))
        # refine: delta-SSE(o) = N o^2 - 2 o E; try o and neighbours
        best = (0, 0)
        for cand in {o, max(lo, o - 1), min(hi, o + 1), 0}:
            dsse = N * cand * cand - 2 * cand * E
            cost = dsse + lam * (abs(cand) + 1)
            if cost < best[1]:
                best = (cand, cost)
        return best

    params = []
    for cy in range(ctus_h):
        for cx in range(ctus_w):
            prm = np.zeros(20, np.int32)
            # ---- luma ----
            sel = (slice(cy * ctu, min((cy + 1) * ctu, h)),
                   slice(cx * ctu, min((cx + 1) * ctu, w)))
            prm_l = _pick_component(
                diffs[0][sel], cat_maps[0], band_maps[0], sel, lam,
                max_off, best_offset)
            prm[0], prm[2], prm[4] = prm_l[0], prm_l[1], prm_l[2]
            prm[8:12] = prm_l[3]
            # ---- chroma (joint type for cb+cr) ----
            scx = 1 << sps.chroma_shift_x
            scy = 1 << sps.chroma_shift_y
            cs = (slice((cy * ctu) // scy,
                        min(((cy + 1) * ctu) // scy, h // scy)),
                  slice((cx * ctu) // scx,
                        min(((cx + 1) * ctu) // scx, w // scx)))
            t, eo, bpos_cb, off_cb, bpos_cr, off_cr = _pick_chroma(
                diffs[1][cs], diffs[2][cs], cat_maps[1], cat_maps[2],
                band_maps[1], band_maps[2], cs, lam, max_off, best_offset)
            prm[1], prm[3] = t, eo
            prm[5], prm[6] = bpos_cb, bpos_cr
            prm[12:16] = off_cb
            prm[16:20] = off_cr
            params.append(prm)
    return params


def _eo_stats(diff, cats):
    E = np.zeros(5, np.int64)
    N = np.zeros(5, np.int64)
    for c in range(1, 5):
        m = cats == c
        N[c] = int(m.sum())
        E[c] = int(diff[m].sum())
    return E, N


def _component_candidates(diff, cat_maps, band_map, sel, lam, max_off,
                          best_offset):
    """Yield (cost, type, eo_class, band_pos, offsets[4]) candidates."""
    yield (lam * 1, 0, 0, 0, np.zeros(4, np.int32))
    # edge classes
    for k in range(4):
        cats = cat_maps[k][sel]
        E, N = _eo_stats(diff, cats)
        offs = np.zeros(4, np.int32)
        cost = lam * 3  # type + eo bits (rough)
        for c in range(1, 5):
            lo, hi = (0, max_off) if c <= 2 else (-max_off, 0)
            o, dc = best_offset(int(E[c]), int(N[c]), lo, hi)
            offs[c - 1] = o
            cost += dc
        yield (cost, 2, k, 0, offs)
    # band
    bm = band_map[sel]
    Eb = np.zeros(32, np.int64)
    Nb = np.zeros(32, np.int64)
    for b in range(32):
        m = bm == b
        Nb[b] = int(m.sum())
        Eb[b] = int(diff[m].sum())
    best_b = None
    for pos in range(32):
        offs = np.zeros(4, np.int32)
        cost = lam * 8  # type + position + sign bits (rough)
        for k in range(4):
            b = (pos + k) & 31
            o, dc = best_offset(int(Eb[b]), int(Nb[b]), -max_off, max_off)
            offs[k] = o
            cost += dc
        if best_b is None or cost < best_b[0]:
            best_b = (cost, 1, 0, pos, offs)
    yield best_b


def _pick_component(diff, cat_maps, band_map, sel, lam, max_off, best_offset):
    best = None
    for cand in _component_candidates(diff, cat_maps, band_map, sel, lam,
                                      max_off, best_offset):
        if best is None or cand[0] < best[0]:
            best = cand
    return (best[1], best[2], best[3], best[4])


def _pick_chroma(diff_cb, diff_cr, cats_cb, cats_cr, band_cb, band_cr, sel,
                 lam, max_off, best_offset):
    """Chroma: shared type + eo class, separate offsets/band positions."""
    best = None
    # off
    cand = (2 * lam, 0, 0, 0, np.zeros(4, np.int32), 0, np.zeros(4, np.int32))
    best = cand
    for k in range(4):
        cost = lam * 3
        offs = []
        for diff, cats in ((diff_cb, cats_cb[k][sel]),
                           (diff_cr, cats_cr[k][sel])):
            E, N = _eo_stats(diff, cats)
            off = np.zeros(4, np.int32)
            for c in range(1, 5):
                lo, hi = (0, max_off) if c <= 2 else (-max_off, 0)
                o, dc = best_offset(int(E[c]), int(N[c]), lo, hi)
                off[c - 1] = o
                cost += dc
            offs.append(off)
        if cost < best[0]:
            best = (cost, 2, k, 0, offs[0], 0, offs[1])
    return best[1], best[2], best[3], best[4], best[5], best[6]
