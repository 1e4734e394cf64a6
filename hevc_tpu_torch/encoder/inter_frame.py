"""P-frame encoder: motion search + skip/merge/inter/intra decision + recon.

Parity: reference TEncSearch::predInterSearch (TEncSearch.cpp:2919, per-PU
merge-vs-AMVP decision), xMotionEstimation:3679 (the CPU/GPU dispatch this
framework replaces with the batched device search in hevc_tpu_torch.ops.sad),
xMergeEstimation:2839 and TEncCu's SKIP trial (TEncCu.cpp:461).

Decision per CU (2Nx2N, low-delay P, single reference):
  1. merge candidates (native derivation) scored by SATD + index bits
  2. integer full-search ME around the AMVP predictor (device kernel),
     AMVP selector chosen by MVD rate
  3. 35-mode intra sweep (inherited)
  pick the cheapest; merge with all-zero residual becomes SKIP.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from .. import runtime
from ..core import tables
from ..entropy.cabac import CtuDecisions, SliceDataEncoder
from ..ops import me
from ..ops.interp import mc_predict_bi_np, mc_predict_np, pad_plane
from ..ops.sad import full_search_batch_kernel
from ..ops.quant import dequantize_np, quantize_np
from ..ops.transform import forward_transform_np, inverse_transform_np
from .intra_frame import IntraFrameEncoder, satd_many
from .quadtree import cu_leaves, tu_leaves

PAD = 80


class PFrameEncoder(IntraFrameEncoder):
    """Low-delay inter frame encoder. With is_b=True it codes a generalized
    B slice whose two lists reference the same (previous) picture, matching
    the lowdelay_main configuration; bi-prediction then enters through the
    combined merge candidates."""

    def __init__(self, sps, qp: int, ref_planes: List[np.ndarray],
                 search_range: int = 16, qp_factor: float = 0.4624,
                 is_b: bool = False, ref1_planes=None, lam=None,
                 device="cuda"):
        self.is_b = is_b
        self.device = runtime.resolve_device(device)
        super().__init__(sps, qp)
        # P-slice lambda (HM qp-factor from the GOP table row; EncoderTop
        # passes the exact picture lambda incl. the depth multiplier)
        self.lam = lam if lam is not None else \
            qp_factor * (2.0 ** ((qp - 12) / 3.0))
        self.sqrt_lam = math.sqrt(self.lam)
        self.lam_fp = int(65536.0 * self.sqrt_lam)  # reference setLambda
        self.search_range = search_range
        self.ref = [pad_plane(p, PAD) for p in ref_planes]
        # list-1 reference (hierarchical B: a different picture; GPB: same)
        self.ref1 = ([pad_plane(p, PAD) for p in ref1_planes]
                     if ref1_planes is not None else self.ref)
        self.senc: SliceDataEncoder = None  # set by caller before encoding

    # -- helpers ------------------------------------------------------------
    def _mc_cu(self, mv, x0, y0, size):
        """Prediction planes (y, cb, cr) for a CU from the reference."""
        py = mc_predict_np(self.ref[0], PAD, mv[0], mv[1], x0, y0,
                           size, size, self.bd, True)
        pcb = mc_predict_np(self.ref[1], PAD, mv[0], mv[1], x0 >> 1, y0 >> 1,
                            size >> 1, size >> 1, self.bd, False)
        pcr = mc_predict_np(self.ref[2], PAD, mv[0], mv[1], x0 >> 1, y0 >> 1,
                            size >> 1, size >> 1, self.bd, False)
        return py, pcb, pcr

    def _code_inter_tb(self, orig_tb, pred, size, qp):
        """-> (levels, recon, rdpcm) with rdpcm the explicit residual
        DPCM choice for lossless TBs (0 off, 1 horizontal, 2 vertical;
        signalled per TB by the slice writer — reference TEncSearch
        RDPCM trial / TComTrQuant bypass branch)."""
        resi = orig_tb.astype(np.int32) - pred.astype(np.int32)
        if getattr(self, "lossless", False):
            # cu_transquant_bypass (spec 8.6.4.1 bypass branch): the
            # residual IS the coefficient array; recon is exact
            lv, rdpcm = resi, 0
            if self.sps.explicit_rdpcm_enabled_flag:
                hor = resi.copy()
                hor[:, 1:] -= resi[:, :-1]
                ver = resi.copy()
                ver[1:, :] -= resi[:-1, :]
                # level-magnitude proxy for the coded cost; ties keep
                # the cheaper-to-signal plain coding
                cands = [(int(np.abs(resi).sum()), 0, resi),
                         (int(np.abs(hor).sum()), 1, hor),
                         (int(np.abs(ver).sum()), 2, ver)]
                _, rdpcm, lv = min(cands, key=lambda t: (t[0], t[1]))
            return lv.copy(), orig_tb.astype(np.int32), rdpcm
        coeff = forward_transform_np(resi, size, self.bd)
        levels = quantize_np(coeff, size, qp, self.bd, is_intra=False)
        if not levels.any():
            return levels, pred.astype(np.int32), 0
        deq = dequantize_np(levels, size, qp, self.bd)
        r = inverse_transform_np(deq, size, self.bd)
        return levels, np.clip(pred.astype(np.int32) + r, 0,
                               (1 << self.bd) - 1), 0

    # -- frame encode -------------------------------------------------------
    def _batched_me(self, orig):
        """One device search over every full-size CU of the frame
        (zero-centred windows, like the reference GPU path's CTU-anchored
        window reuse — the signalled MVD is rated against the real AMVP
        predictor afterwards): one launch of the fused full-search kernel
        (SAD, lambda*mv-bits cost and argmin) on a card, its plain version
        on the CPU."""
        size = self.ctu >> self.cu_depth_target
        R = self.search_range
        pos = [(x0, y0)
               for y0 in range(0, self.h - size + 1, size)
               for x0 in range(0, self.w - size + 1, size)]
        if not pos:
            return {}
        blks = np.stack([orig[0][y0:y0 + size, x0:x0 + size]
                         for (x0, y0) in pos]).astype(np.int32)
        areas = np.stack([
            self.ref[0][PAD + y0 - R: PAD + y0 + R + size,
                        PAD + x0 - R: PAD + x0 + R + size]
            for (x0, y0) in pos]).astype(np.int32)
        n = len(pos)
        # the batch is padded to a coarse bucket as the reference pads it
        # (there so XLA compiles one shape per (block size, range))
        bucket = max(128, 1 << (n - 1).bit_length())
        if n < bucket:
            blks = np.concatenate([blks, np.zeros((bucket - n,) + blks.shape[1:], np.int32)])
            areas = np.concatenate([areas, np.zeros((bucket - n,) + areas.shape[1:], np.int32)])
        dev = self.device
        zeros = torch.zeros(bucket, dtype=torch.int32, device=dev)
        mins = torch.full((bucket,), -R, dtype=torch.int32, device=dev)
        mv_y, mv_x, _, sad = full_search_batch_kernel(
            runtime.upload(blks, dev), runtime.upload(areas, dev), mins,
            mins, zeros, zeros, self.lam_fp)
        mv_y, mv_x = mv_y.cpu().numpy(), mv_x.cpu().numpy()
        sad = sad.cpu().numpy()
        return {p: (int(mv_x[i]), int(mv_y[i]), int(sad[i]))
                for i, p in enumerate(pos)}

    def encode_frame(self, orig: List[np.ndarray]):
        w, h, ctu = self.w, self.h, self.ctu
        sx, sy = self.sps.chroma_shift_x, self.sps.chroma_shift_y
        # sample dtype: int16 through 14-bit internal depth, int32 at 16
        pdt = self._pdt  # noqa: F841 (kept for local readers)
        recon = [np.zeros((h, w), pdt),
                 np.zeros((h >> sy, w >> sx), pdt),
                 np.zeros((h >> sy, w >> sx), pdt)]
        mode_map = np.full(((h + 3) >> 2, (w + 3) >> 2), 1, np.uint8)
        self._me = self._batched_me(orig)
        ctus_w = -(-w // ctu)
        ctus_h = -(-h // ctu)
        decisions = []
        for cy in range(ctus_h):
            for cx in range(ctus_w):
                d = CtuDecisions(ctu,
                                 chroma_format=self.sps.chroma_format_idc)
                d.cu_depth[:] = self.cu_depth_target
                x0c, y0c = cx * ctu, cy * ctu
                for (x0, y0, log2) in cu_leaves(
                        d.cu_depth, x0c, y0c, w, h,
                        ctu_log2=tables.log2(ctu)):
                    self._encode_cu_p(orig, recon, mode_map, d, x0c, y0c,
                                      x0, y0, log2)
                decisions.append(d)
        return decisions, recon

    def _merge_pred(self, l0, l1, x0, y0, size):
        mv0, r0 = l0
        mv1, r1 = l1
        if r0 >= 0 and r1 >= 0:
            return mc_predict_bi_np(self.ref[0], self.ref1[0], PAD, mv0, mv1,
                                    x0, y0, size, size, self.bd, True)
        mv = mv0 if r0 >= 0 else mv1
        refs = self.ref if r0 >= 0 else self.ref1
        return mc_predict_np(refs[0], PAD, mv[0], mv[1], x0, y0,
                             size, size, self.bd, True)

    def _frac_refine(self, orig_y, x0, y0, size, mv_q):
        """Half- then quarter-pel 9-point SATD refinement around mv_q."""
        o = orig_y.astype(np.int64)

        def cost(mv):
            pred = mc_predict_np(self.ref[0], PAD, mv[0], mv[1], x0, y0,
                                 size, size, self.bd, True)
            return int(satd_many((o - pred)[None])[0])

        best, best_c = mv_q, cost(mv_q)
        for step in (2, 1):
            center = best
            for dy in (-step, 0, step):
                for dx in (-step, 0, step):
                    if dx == 0 and dy == 0:
                        continue
                    mv = (center[0] + dx, center[1] + dy)
                    c = cost(mv)
                    if c < best_c:
                        best, best_c = mv, c
        return best

    def _set_inter_maps(self, d, bx, by, nb, *, skip, merge_f, merge_i,
                        mvp_f, mv, mvd, ref, mv1=(0, 0), ref1=-1):
        sl = (slice(by, by + nb), slice(bx, bx + nb))
        d.pred_mode[sl] = 0
        d.skip_flag[sl] = skip
        d.merge_flag[sl] = merge_f
        d.merge_idx[sl] = merge_i
        d.mvp_flag[sl] = mvp_f
        d.ref_idx[sl] = ref
        d.mvd_x[sl], d.mvd_y[sl] = mvd
        d.mv_x[sl], d.mv_y[sl] = mv
        d.ref_idx1[sl] = ref1
        d.mv_x1[sl], d.mv_y1[sl] = mv1

    def _encode_cu_p(self, orig, recon, mode_map, d, ctu_x0, ctu_y0,
                     x0, y0, log2):
        size = 1 << log2
        bx, by = (x0 - ctu_x0) >> 2, (y0 - ctu_y0) >> 2
        nb = size >> 2
        orig_y = orig[0][y0:y0 + size, x0:x0 + size]

        # 8x8 boundary CUs stay intra (avoids min-size inter part_mode)
        if log2 <= 3:
            super()._encode_cu(orig, recon, mode_map, d, ctu_x0, ctu_y0,
                               x0, y0, log2)
            self.senc.publish_cu(x0, y0, log2, True)
            return

        # ---- merge candidates (uni or bi) ----
        cands = self.senc.merge_cands(x0, y0, size)
        merge_best = None
        seen = set()
        for idx, (l0, l1) in enumerate(cands):
            key = (l0, l1)
            if key in seen:
                continue
            seen.add(key)
            pred = self._merge_pred(l0, l1, x0, y0, size)
            cost = int(satd_many((orig_y.astype(np.int64) - pred)[None])[0])
            cost += int(self.sqrt_lam * (idx + 1) + 0.5)
            if merge_best is None or cost < merge_best[0]:
                merge_best = (cost, idx, l0, l1, pred)

        # ---- AMVP + integer MV from the frame-batched device search ----
        amvp = self.senc.amvp_cands(x0, y0, size, 0, 0)
        me_hit = self._me.get((x0, y0))
        if me_hit is not None:
            mv_x, mv_y, sad = me_hit
            # fractional refinement: half-pel 8-neighbour + quarter-pel
            # 8-neighbour SATD search (reference xPatternSearchFracDIF:4294
            # with HadamardME). Interpolated predictions via the MC filters.
            mv_int = self._frac_refine(orig_y, x0, y0, size,
                                       (mv_x << 2, mv_y << 2))
            bits0 = (me.mv_bits_np(mv_int[0] - amvp[0][0])
                     + me.mv_bits_np(mv_int[1] - amvp[0][1]))
            bits1 = (me.mv_bits_np(mv_int[0] - amvp[1][0])
                     + me.mv_bits_np(mv_int[1] - amvp[1][1]))
            mvp_f = 0 if bits0 <= bits1 else 1
            mvd = (mv_int[0] - amvp[mvp_f][0], mv_int[1] - amvp[mvp_f][1])
            pred_inter = mc_predict_np(self.ref[0], PAD, mv_int[0],
                                       mv_int[1], x0, y0, size, size,
                                       self.bd, True)
            cost_inter = int(satd_many(
                (orig_y.astype(np.int64) - pred_inter)[None])[0])
            cost_inter += int(self.sqrt_lam * (min(bits0, bits1) + 3) + 0.5)
        else:  # boundary CU: no search; merge/intra (or zero MV) only
            mv_int = (0, 0)
            mvp_f = 0
            mvd = (-amvp[0][0], -amvp[0][1])
            pred_inter = mc_predict_np(self.ref[0], PAD, 0, 0, x0, y0,
                                       size, size, self.bd, True)
            cost_inter = int(satd_many(
                (orig_y.astype(np.int64) - pred_inter)[None])[0])
            cost_inter += int(self.sqrt_lam * 8 + 0.5)

        # ---- intra cost (quick SATD screen) ----
        from .intra_frame import mpm_list
        f, ff = self._refs(recon[0], x0, y0, size)
        mpms = mpm_list(mode_map, x0, y0, self.avail, self.ctu)
        preds = np.stack([self._predict(f, ff, m, size, True)
                          for m in range(35)])
        satds = satd_many(orig_y.astype(np.int64)[None] - preds)
        ibits = np.array([self._mode_bits(m, mpms) for m in range(35)])
        icosts = satds + (self.sqrt_lam * ibits + 0.5).astype(np.int64)
        imode = int(np.argmin(icosts))
        cost_intra = int(icosts[imode]) + int(self.sqrt_lam * 8)

        best = min(merge_best[0], cost_inter, cost_intra)
        if best == cost_intra:
            super()._encode_cu(orig, recon, mode_map, d, ctu_x0, ctu_y0,
                               x0, y0, log2)
            self.senc.publish_cu(x0, y0, log2, True)
            return

        if best == merge_best[0]:
            _, mi_idx, l0, l1, pred_y = merge_best
            mv, ref = l0
            mv1, ref1 = l1
        else:
            mi_idx, mv, ref, pred_y = -1, mv_int, 0, pred_inter
            mv1, ref1 = (0, 0), -1

        # residual for the whole CU (TU == CU); 4:2:2 codes the chroma
        # of a luma TB as two square sub-TBs stacked vertically
        off = getattr(self, "cqp_off", (0, 0))
        qp_cb = tables.chroma_qp(self.qp, self.sps.chroma_format_idc,
                                 off[0])
        qp_cr = tables.chroma_qp(self.qp, self.sps.chroma_format_idc,
                                 off[1])
        sx, sy = self.sps.chroma_shift_x, self.sps.chroma_shift_y
        cxx, cyy = x0 >> sx, y0 >> sy
        cs = size >> sx                 # square chroma TB size
        chh = size >> sy                # chroma block height (2*cs at 422)
        mono = self.sps.chroma_format_idc == 0
        if mono:  # monochrome: no chroma prediction/residual
            pcb = pcr = None
        elif ref >= 0 and ref1 >= 0:
            pcb = mc_predict_bi_np(self.ref[1], self.ref1[1], PAD, mv, mv1,
                                   cxx, cyy, cs, chh, self.bd, False,
                                   chroma_shift=(sx, sy))
            pcr = mc_predict_bi_np(self.ref[2], self.ref1[2], PAD, mv, mv1,
                                   cxx, cyy, cs, chh, self.bd, False,
                                   chroma_shift=(sx, sy))
        else:
            umv = mv if ref >= 0 else mv1
            crefs = self.ref if ref >= 0 else self.ref1
            pcb = mc_predict_np(crefs[1], PAD, umv[0], umv[1], cxx, cyy,
                                cs, chh, self.bd, False,
                                chroma_shift=(sx, sy))
            pcr = mc_predict_np(crefs[2], PAD, umv[0], umv[1], cxx, cyy,
                                cs, chh, self.bd, False,
                                chroma_shift=(sx, sy))
        ly, lx = y0 - ctu_y0, x0 - ctu_x0
        lv_y, rec_y, rd_y = self._code_inter_tb(orig_y, pred_y, size,
                                                self.qp)
        if rd_y:
            d.rext[ly >> 2, lx >> 2] |= 1 | ((rd_y - 1) << 1)
        lv_cb = np.zeros((chh, cs), np.int32)
        rec_cb = np.zeros((chh, cs), np.int32)
        lv_cr = np.zeros((chh, cs), np.int32)
        rec_cr = np.zeros((chh, cs), np.int32)
        for half in range(0 if mono else chh // cs):
            hsl = slice(half * cs, (half + 1) * cs)
            # chroma sub-TB origin in LUMA coordinates (4:2:2 codes two
            # stacked square sub-TBs per luma TB; the slice codec's rext
            # bits live at the sub-TB origin, decoder mirror)
            ry = (ly + half * (size >> 1)) >> 2
            lv_cb[hsl], rec_cb[hsl], rd_cb = self._code_inter_tb(
                orig[1][cyy + half * cs:cyy + (half + 1) * cs,
                        cxx:cxx + cs], pcb[hsl], cs, qp_cb)
            if rd_cb:
                d.rext[ry, lx >> 2] |= (1 | ((rd_cb - 1) << 1)) << 2
            lv_cr[hsl], rec_cr[hsl], rd_cr = self._code_inter_tb(
                orig[2][cyy + half * cs:cyy + (half + 1) * cs,
                        cxx:cxx + cs], pcr[hsl], cs, qp_cr)
            if rd_cr:
                d.rext[ry, lx >> 2] |= (1 | ((rd_cr - 1) << 1)) << 4
        zero_resid = not (lv_y.any() or lv_cb.any() or lv_cr.any())

        if mi_idx >= 0:
            skip = 1 if zero_resid else 0
            self._set_inter_maps(d, bx, by, nb, skip=skip, merge_f=1,
                                 merge_i=mi_idx, mvp_f=0, mv=mv,
                                 mvd=(0, 0), ref=ref, mv1=mv1, ref1=ref1)
        else:
            self._set_inter_maps(d, bx, by, nb, skip=0, merge_f=0,
                                 merge_i=0, mvp_f=mvp_f, mv=mv, mvd=mvd,
                                 ref=0)
        # store coefficients + recon
        ly, lx = y0 - ctu_y0, x0 - ctu_x0
        d.coeff_y[ly:ly + size, lx:lx + size] = lv_y.astype(np.int16)
        d.coeff_cb[ly >> sy:(ly >> sy) + chh,
                   lx >> sx:(lx >> sx) + cs] = lv_cb.astype(np.int16)
        d.coeff_cr[ly >> sy:(ly >> sy) + chh,
                   lx >> sx:(lx >> sx) + cs] = lv_cr.astype(np.int16)
        recon[0][y0:y0 + size, x0:x0 + size] = rec_y.astype(self._pdt)
        recon[1][cyy:cyy + chh, cxx:cxx + cs] = rec_cb.astype(self._pdt)
        recon[2][cyy:cyy + chh, cxx:cxx + cs] = rec_cr.astype(self._pdt)
        # intra mode map: inter blocks act as DC for MPM purposes
        mode_map[y0 >> 2:(y0 + size) >> 2, x0 >> 2:(x0 + size) >> 2] = 1
        self.senc.publish_cu(x0, y0, log2, False, skip=int(mi_idx >= 0 and
                                                           zero_resid),
                             mv=mv, ref_idx=ref, mv1=mv1, ref_idx1=ref1)