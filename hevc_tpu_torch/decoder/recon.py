"""CTU reconstruction from parsed decision maps.

Parity: reference TDecCu::xDecompressCU (TDecCu.cpp:336 — intra recon,
inter MC, residual add), sharing this framework's encoder recon math
(intra_np predictor, transform/quant inverses, MC interpolation) so the
encoder and decoder cannot drift apart.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core import tables
from ..core.geometry import AvailabilityMap
from ..core.params import SPS
from ..core.refsamples import build_ref_vector
from ..encoder.quadtree import cu_leaves, tu_leaves
from ..ops import intra_np
from ..ops.interp import mc_predict_bi_np, mc_predict_np, mc_predict_wp_np
from ..ops.intra import filter_ref_samples, strong_smoothing_decision
from ..ops.quant import dequantize_np
from ..ops.transform import inverse_transform_np, inverse_ts_np

PAD = 80


def _pu_rect(part, pu, n):
    """Inter PU geometry (mirror of the native pu_rect; part codes
    0=2Nx2N, 2=2NxN, 3=Nx2N, 4=2NxnU, 5=2NxnD, 6=nLx2N, 7=nRx2N)."""
    q = n >> 2
    if part == 2:
        return 0, pu * (n >> 1), n, n >> 1
    if part == 3:
        return pu * (n >> 1), 0, n >> 1, n
    if part == 4:
        return 0, q if pu else 0, n, (n - q) if pu else q
    if part == 5:
        return 0, (n - q) if pu else 0, n, q if pu else (n - q)
    if part == 6:
        return (q if pu else 0), 0, (n - q) if pu else q, n
    if part == 7:
        return ((n - q) if pu else 0), 0, (q if pu else (n - q)), n
    return 0, 0, n, n


class CtuReconstructor:
    def __init__(self, sps: SPS, slice_qp: int,
                 refs_l0=None, refs_l1=None, wp=None, wp_tables=None,
                 wp_denoms=(6, 6), slice_start_ctu: int = 0,
                 cb_qp_offset: int = 0, cr_qp_offset: int = 0,
                 cip_map=None):
        """refs_l0/refs_l1: per-list padded reference pictures (each a
        [Y,Cb,Cr] plane list), indexed by ref_idx (spec 8.5.3.1).
        wp: legacy (log2_denom, weight, offset) explicit luma weighting
        for list-0 ref 0. wp_tables: full pred_weight_table —
        wp_tables[list][ref] = (luma (w, o) or None, chroma
        [(w, o), (w, o)] or None); wp_denoms = (luma, chroma) log2."""
        self.sps = sps
        self.qp = slice_qp
        # per-component chroma QP (spec 8.6.1: qPiCb/qPiCr apply the
        # pps+slice offsets BEFORE the 4:2:0 mapping table)
        self.cb_off = cb_qp_offset
        self.cr_off = cr_qp_offset
        self.qp_cb = tables.chroma_qp(slice_qp, sps.chroma_format_idc,
                                      cb_qp_offset)
        self.qp_cr = tables.chroma_qp(slice_qp, sps.chroma_format_idc,
                                      cr_qp_offset)
        self.bd = sps.bit_depth_luma
        self.w = sps.pic_width_in_luma_samples
        self.h = sps.pic_height_in_luma_samples
        self.ctu = sps.ctu_size
        self.avail = AvailabilityMap(
            self.w, self.h, self.ctu,
            tile_cols=getattr(sps, "_tile_cols", 0),
            tile_rows=getattr(sps, "_tile_rows", 0),
            slice_start_ctu=slice_start_ctu)
        self.refs_l0 = refs_l0 or []
        self.refs_l1 = refs_l1 if refs_l1 is not None else self.refs_l0
        self.wp = wp
        self.wp_tables = wp_tables
        self.wp_denoms = wp_denoms
        self.csx = sps.chroma_shift_x
        self.csy = sps.chroma_shift_y
        # constrained intra prediction (PPS constrained_intra_pred_flag):
        # picture-level bool map at 4x4 luma granularity, True where the
        # block decoded intra — inter neighbour samples substitute
        # (spec 8.4.4.2.2; reference TComPattern fillReferenceSamples)
        self.cip_map = cip_map

    def set_qp(self, qp: int) -> None:
        """Per-CTU QP for cu_qp_delta streams (the signalled group QP —
        every CU with coefficients in the group dequantizes with it)."""
        self.qp = qp
        self.qp_cb = tables.chroma_qp(qp, self.sps.chroma_format_idc,
                                      self.cb_off)
        self.qp_cr = tables.chroma_qp(qp, self.sps.chroma_format_idc,
                                      self.cr_off)

    def _resid(self, coeffs, size, c_idx, ts, is_dst=False, intra=False,
               rdpcm=0, bypass=False):
        """Final residual of one TB: dequant, inverse (or skipped)
        transform, then the range-extension residual modifications —
        180-degree rotation of 4x4 intra TS residuals
        (transform_skip_rotation, reference TComTU
        isNonTransformedResidualRotated) and RDPCM accumulation along
        the prediction direction (reference TComTrQuant::invRdpcmNxN;
        rdpcm: 0 off, 1 horizontal, 2 vertical). bypass: lossless
        cu_transquant_bypass CU — the coded levels ARE the residual
        (spec 8.6.4.1)."""
        bypass = bypass or getattr(self, "_cu_bypass", False)
        if bypass:
            r = coeffs.astype(np.int32)
        else:
            qp = self.qp if c_idx == 0 else (
                self.qp_cb if c_idx == 1 else self.qp_cr)
            sm = None
            if self.sps.scaling_list_enabled_flag:
                # pps data overrides sps data overrides the spec defaults
                # (spec 7.4.3.3; reference TComSlice::setScalingList)
                sld = getattr(self.sps, "_scaling_data", None)
                if sld is not None:
                    sm = sld.matrix(size, c_idx, intra)
                else:
                    sm = tables.default_scaling_matrix(size, intra)
            deq = dequantize_np(coeffs.astype(np.int32), size, qp, self.bd,
                                scaling=sm)
            r = (inverse_ts_np(deq, self.bd) if ts else
                 inverse_transform_np(deq, size, self.bd, is_dst=is_dst))
        if ts or bypass:
            if (intra and size == 4 and
                    self.sps.transform_skip_rotation_enabled_flag):
                r = r[::-1, ::-1]
            if rdpcm == 1:
                r = np.cumsum(r, axis=1)
            elif rdpcm == 2:
                r = np.cumsum(r, axis=0)
        return r

    @staticmethod
    def _ccp_term(alpha, luma_resi):
        """Cross-component prediction residual term (spec 8.6.6,
        reference TComTrQuant::crossComponentPrediction):
        (alpha * lumaResidual) >> 3 with arithmetic shift."""
        return (int(alpha) * luma_resi) >> 3

    def _intra_tb(self, recon, x0, y0, size, mode, c_idx, coeffs, is_dst,
                  luma_pos=None, ts=False, rdpcm=0, ccp_alpha=0,
                  luma_resi=None, bypass=False):
        plane = recon[c_idx]
        f = build_ref_vector(plane, x0, y0, size, self.avail,
                             self.bd, luma_pos=luma_pos,
                             cip_mask=self.cip_map)
        strong = (c_idx == 0 and self.sps.strong_intra_smoothing_enabled_flag
                  and strong_smoothing_decision(f, size, self.bd))
        ff = filter_ref_samples(f, size, self.bd, strong_smoothing=strong)
        # smoothing also applies to chroma in 4:4:4 (spec 8.4.4.2.3);
        # the hor/ver/DC boundary filters are disabled for lossless CUs
        # when implicit RDPCM is enabled (reference
        # TComPrediction.cpp:481 enableEdgeFilters)
        smooth = c_idx == 0 or self.sps.chroma_format_idc == 3
        edge = not (self.sps.implicit_rdpcm_enabled_flag
                    and getattr(self, "_cu_bypass", False))
        pred = intra_np.predict_mode(f, ff, mode, size, self.bd,
                                     is_luma=(c_idx == 0), smooth=smooth,
                                     edge_filters=edge)
        r = None
        if coeffs.any():
            r = self._resid(coeffs, size, c_idx, ts, is_dst=is_dst,
                            intra=True, rdpcm=rdpcm, bypass=bypass)
        if ccp_alpha and luma_resi is not None:
            ccp = self._ccp_term(ccp_alpha, luma_resi)
            r = ccp if r is None else r + ccp
        if r is not None:
            pred = pred + r
        plane[y0:y0 + size, x0:x0 + size] = np.clip(
            pred, 0, (1 << self.bd) - 1)
        return r

    def _add_resid(self, recon, pred, x0, y0, size, c_idx, coeffs,
                   ts=False, rdpcm=0, ccp_alpha=0, luma_resi=None,
                   bypass=False):
        r = None
        if coeffs.any():
            r = self._resid(coeffs, size, c_idx, ts, rdpcm=rdpcm,
                            bypass=bypass)
        if ccp_alpha and luma_resi is not None:
            ccp = self._ccp_term(ccp_alpha, luma_resi)
            r = ccp if r is None else r + ccp
        if r is not None:
            pred = pred + r
        recon[c_idx][y0:y0 + size, x0:x0 + size] = np.clip(
            pred, 0, (1 << self.bd) - 1)
        return r

    def recon_ctu(self, d, cx: int, cy: int, recon: List[np.ndarray],
                  qp4=None):
        """qp4: per-4x4 luma QP map of this CTU (cu_qp_delta streams —
        with sub-CTU quantization groups each CU dequantizes with its
        own QpY, spec 8.6.1)."""
        ctu_x0, ctu_y0 = cx * self.ctu, cy * self.ctu
        min_cb = self.sps.log2_min_luma_coding_block_size_minus3 + 3
        if self.cip_map is not None:
            # record this CTU's intra/inter map before reconstructing:
            # z-scan availability already excludes not-yet-decoded blocks
            b4 = self.ctu >> 2
            my0, mx0 = ctu_y0 >> 2, ctu_x0 >> 2
            mh = min(b4, self.cip_map.shape[0] - my0)
            mw = min(b4, self.cip_map.shape[1] - mx0)
            self.cip_map[my0:my0 + mh, mx0:mx0 + mw] = \
                (d.pred_mode[:mh, :mw] == 1)
        for (x0, y0, log2) in cu_leaves(d.cu_depth, ctu_x0, ctu_y0,
                                        self.w, self.h,
                                        ctu_log2=tables.log2(self.ctu),
                                        min_cb_log2=min_cb):
            lx, ly = x0 - ctu_x0, y0 - ctu_y0
            if qp4 is not None:
                q = int(qp4[ly >> 2, lx >> 2])
                if q != self.qp:
                    self.set_qp(q)
            # cu_transquant_bypass (lossless CU): residual passthrough,
            # flagged on bit 0x40 of the parser's rext map
            rx = getattr(d, "rext", None)
            self._cu_bypass = bool(rx is not None
                                   and rx[ly >> 2, lx >> 2] & 0x40)
            if d.pred_mode[ly >> 2, lx >> 2] == 1:
                self._recon_intra_cu(d, recon, ctu_x0, ctu_y0, x0, y0, log2)
            else:
                self._recon_inter_cu(d, recon, ctu_x0, ctu_y0, x0, y0, log2)

    def _irdpcm(self, mode, ts):
        """Implicit RDPCM direction for an intra TS (or lossless
        transquant-bypass) TB (spec RExt: horizontal/vertical prediction
        accumulates the residual)."""
        if not ((ts or getattr(self, "_cu_bypass", False))
                and self.sps.implicit_rdpcm_enabled_flag):
            return 0
        return 1 if mode == 10 else (2 if mode == 26 else 0)

    @staticmethod
    def _erdpcm(d, lx, ly, comp):
        """Explicit RDPCM mode for an inter TB from the parser's rext
        bits at the TB origin (0 off, 1 horizontal, 2 vertical)."""
        rext = getattr(d, "rext", None)
        if rext is None:
            return 0
        b = int(rext[ly >> 2, lx >> 2]) >> (comp * 2)
        return ((b >> 1 & 1) + 1) if (b & 1) else 0

    @staticmethod
    def _ccp_of(d, lx, ly, comp):
        m = getattr(d, "ccp_cb" if comp == 1 else "ccp_cr", None)
        return int(m[ly >> 2, lx >> 2]) if m is not None else 0

    @staticmethod
    def _ts_of(d, lx, ly, bit):
        """Transform-skip flag from the tu_depth high bits at the TB origin
        (lx/ly = luma offsets within the CTU); bit: 0x10 Y, 0x20 Cb,
        0x40 Cr."""
        return bool(d.tu_depth[ly >> 2, lx >> 2] & bit)

    def _recon_intra_cu(self, d, recon, ctu_x0, ctu_y0, x0, y0, log2):
        lx, ly = x0 - ctu_x0, y0 - ctu_y0
        if d.tu_depth[ly >> 2, lx >> 2] & 0x80:
            # I_PCM: the raw samples ride the coeff planes (spec 8.4.1).
            # The int16 maps wrap samples above 2^15 (16-bit depth);
            # masking to the sample width recovers the unsigned value.
            n = 1 << log2
            m = (1 << self.bd) - 1
            recon[0][y0:y0 + n, x0:x0 + n] = \
                d.coeff_y[ly:ly + n, lx:lx + n].astype(np.int32) & m
            if self.sps.chroma_format_idc == 0:
                return  # monochrome: luma samples only
            sx, sy = self.csx, self.csy
            cw, chh = n >> sx, n >> sy
            recon[1][y0 >> sy:(y0 >> sy) + chh, x0 >> sx:(x0 >> sx) + cw] = \
                d.coeff_cb[ly >> sy:(ly >> sy) + chh,
                           lx >> sx:(lx >> sx) + cw].astype(np.int32) & m
            recon[2][y0 >> sy:(y0 >> sy) + chh, x0 >> sx:(x0 >> sx) + cw] = \
                d.coeff_cr[ly >> sy:(ly >> sy) + chh,
                           lx >> sx:(lx >> sx) + cw].astype(np.int32) & m
            return
        nxn = bool(d.nxn_flag[ly >> 2, lx >> 2])
        cmode = int(d.chroma_mode[ly >> 2, lx >> 2])
        for (tx, ty, tlog2, tdepth, blk) in tu_leaves(
                d.tu_depth, x0, y0, log2, ctu_x0, ctu_y0, intra_split=nxn,
                max_tu_depth_intra=self.sps.max_transform_hierarchy_depth_intra):
            tsize = 1 << tlog2
            tlx, tly = tx - ctu_x0, ty - ctu_y0
            mode = int(d.luma_mode[tly >> 2, tlx >> 2])
            coeffs = d.coeff_y[tly:tly + tsize, tlx:tlx + tsize]
            ts_y = self._ts_of(d, tlx, tly, 0x10)
            r_y = self._intra_tb(recon, tx, ty, tsize, mode, 0, coeffs,
                                 is_dst=(tlog2 == 2), ts=ts_y,
                                 rdpcm=self._irdpcm(mode, ts_y))
            if self.sps.chroma_format_idc == 0:
                continue  # monochrome: no chroma TBs
            if self.sps.chroma_format_idc == 3:
                # 4:4:4: full-size chroma TB per luma TU leaf (per-part
                # chroma mode map covers NxN partitions)
                pcmode = int(d.chroma_mode[tly >> 2, tlx >> 2])
                ccb = d.coeff_cb[tly:tly + tsize, tlx:tlx + tsize]
                ccr = d.coeff_cr[tly:tly + tsize, tlx:tlx + tsize]
                ts_cb = self._ts_of(d, tlx, tly, 0x20)
                ts_cr = self._ts_of(d, tlx, tly, 0x40)
                self._intra_tb(recon, tx, ty, tsize, pcmode, 1, ccb, False,
                               luma_pos=(tx, ty, 1, 1), ts=ts_cb,
                               rdpcm=self._irdpcm(pcmode, ts_cb),
                               ccp_alpha=self._ccp_of(d, tlx, tly, 1),
                               luma_resi=r_y)
                self._intra_tb(recon, tx, ty, tsize, pcmode, 2, ccr, False,
                               luma_pos=(tx, ty, 1, 1), ts=ts_cr,
                               rdpcm=self._irdpcm(pcmode, ts_cr),
                               ccp_alpha=self._ccp_of(d, tlx, tly, 2),
                               luma_resi=r_y)
            elif self.sps.chroma_format_idc == 2:
                # 4:2:2: TWO square chroma sub-TBs stacked vertically per
                # luma TB (or per blk-3 parent), chroma y == luma y
                # (reference TComTU two-sub-TU iteration; the mode map
                # already holds the Table 8-3 remapped direction)
                if tlog2 > 2:
                    bx, by, blog2 = tx, ty, tlog2
                elif blk == 3:
                    bx, by = tx - (1 << tlog2), ty - (1 << tlog2)
                    blog2 = tlog2 + 1
                else:
                    continue
                cs = 1 << (blog2 - 1)
                blx = bx - ctu_x0
                for half in range(2):
                    hy = by + half * cs          # luma == chroma row
                    hly = hy - ctu_y0
                    ccb = d.coeff_cb[hly:hly + cs, blx >> 1:(blx >> 1) + cs]
                    ccr = d.coeff_cr[hly:hly + cs, blx >> 1:(blx >> 1) + cs]
                    ts_cb = self._ts_of(d, blx, hly, 0x20)
                    ts_cr = self._ts_of(d, blx, hly, 0x40)
                    self._intra_tb(recon, bx >> 1, hy, cs, cmode, 1, ccb,
                                   False, luma_pos=(bx, hy, 2, 1), ts=ts_cb,
                                   rdpcm=self._irdpcm(cmode, ts_cb))
                    self._intra_tb(recon, bx >> 1, hy, cs, cmode, 2, ccr,
                                   False, luma_pos=(bx, hy, 2, 1), ts=ts_cr,
                                   rdpcm=self._irdpcm(cmode, ts_cr))
            elif tlog2 > 2:
                cs = tsize >> 1
                ccb = d.coeff_cb[tly >> 1:(tly >> 1) + cs,
                                 tlx >> 1:(tlx >> 1) + cs]
                ccr = d.coeff_cr[tly >> 1:(tly >> 1) + cs,
                                 tlx >> 1:(tlx >> 1) + cs]
                ts_cb = self._ts_of(d, tlx, tly, 0x20)
                ts_cr = self._ts_of(d, tlx, tly, 0x40)
                self._intra_tb(recon, tx >> 1, ty >> 1, cs, cmode, 1, ccb,
                               False, luma_pos=(tx, ty, 2, 2), ts=ts_cb,
                               rdpcm=self._irdpcm(cmode, ts_cb))
                self._intra_tb(recon, tx >> 1, ty >> 1, cs, cmode, 2, ccr,
                               False, luma_pos=(tx, ty, 2, 2), ts=ts_cr,
                               rdpcm=self._irdpcm(cmode, ts_cr))
            elif blk == 3:
                bx, by = tx - (1 << tlog2), ty - (1 << tlog2)
                blx, bly = bx - ctu_x0, by - ctu_y0
                ccb = d.coeff_cb[bly >> 1:(bly >> 1) + 4,
                                 blx >> 1:(blx >> 1) + 4]
                ccr = d.coeff_cr[bly >> 1:(bly >> 1) + 4,
                                 blx >> 1:(blx >> 1) + 4]
                ts_cb = self._ts_of(d, blx, bly, 0x20)
                ts_cr = self._ts_of(d, blx, bly, 0x40)
                self._intra_tb(recon, bx >> 1, by >> 1, 4, cmode, 1, ccb,
                               False, luma_pos=(bx, by, 2, 2), ts=ts_cb,
                               rdpcm=self._irdpcm(cmode, ts_cb))
                self._intra_tb(recon, bx >> 1, by >> 1, 4, cmode, 2, ccr,
                               False, luma_pos=(bx, by, 2, 2), ts=ts_cr,
                               rdpcm=self._irdpcm(cmode, ts_cr))

    def _clip_mv(self, mv, cu_x, cu_y):
        """MV clip to picture + margin (reference TComDataCU::clipMv
        :2907, applied in TComPrediction::xPredInterUni:594 on both the
        encoder and decoder paths — merge/AMVP candidates can point far
        outside the padded reference area)."""
        off = 8
        hmax = (self.w + off - cu_x - 1) << 2
        hmin = (-self.ctu - off - cu_x + 1) << 2
        vmax = (self.h + off - cu_y - 1) << 2
        vmin = (-self.ctu - off - cu_y + 1) << 2
        return (min(hmax, max(hmin, mv[0])), min(vmax, max(vmin, mv[1])))

    def _wp_of(self, lx, ridx):
        if self.wp_tables is not None:
            tab = self.wp_tables[lx]
            if ridx < len(tab):
                return tab[ridx]
        if self.wp is not None and lx == 0 and ridx == 0:
            dnm, wgt, off = self.wp
            return ((wgt, off), None)
        return (None, None)

    def _pu_pred(self, d, ctu_x0, ctu_y0, px, py, pw, ph, cu_x, cu_y):
        """Prediction planes for one PU rectangle (spec 8.5.3)."""
        bi, bj = (py - ctu_y0) >> 2, (px - ctu_x0) >> 2
        mv = self._clip_mv((int(d.mv_x[bi, bj]), int(d.mv_y[bi, bj])),
                           cu_x, cu_y)
        r0 = int(d.ref_idx[bi, bj])
        r1 = int(d.ref_idx1[bi, bj])
        mv1 = self._clip_mv((int(d.mv_x1[bi, bj]), int(d.mv_y1[bi, bj])),
                            cu_x, cu_y)
        csx, csy = self.csx, self.csy
        cw, chh = pw >> csx, ph >> csy
        cx, cy = px >> csx, py >> csy
        if self.sps.chroma_format_idc == 0:
            # monochrome: luma MC only (no chroma planes exist)
            z = np.zeros((chh, cw), np.int32)
            if r0 >= 0 and r1 >= 0:
                f0, f1 = self.refs_l0[r0], self.refs_l1[r1]
                if self.wp_tables is not None:
                    from ..ops.interp import mc_predict_bi_wp_np
                    ld, _cd = self.wp_denoms
                    lw0, _ = self._wp_of(0, r0)
                    lw1, _ = self._wp_of(1, r1)
                    lw0 = lw0 or (1 << ld, 0)
                    lw1 = lw1 or (1 << ld, 0)
                    py_ = mc_predict_bi_wp_np(
                        f0[0], f1[0], PAD, mv, mv1, px, py, pw, ph,
                        lw0[0], lw0[1], lw1[0], lw1[1], ld, self.bd, True)
                else:
                    py_ = mc_predict_bi_np(f0[0], f1[0], PAD, mv, mv1,
                                           px, py, pw, ph, self.bd, True)
            else:
                umv = mv if r0 >= 0 else mv1
                lx0 = 0 if r0 >= 0 else 1
                ridx = r0 if r0 >= 0 else r1
                f = self.refs_l0[ridx] if lx0 == 0 else self.refs_l1[ridx]
                lw, _ = self._wp_of(lx0, ridx)
                if lw is not None:
                    py_ = mc_predict_wp_np(f[0], PAD, umv[0], umv[1], px,
                                           py, pw, ph, self.bd, True,
                                           lw[0], lw[1], self.wp_denoms[0])
                else:
                    py_ = mc_predict_np(f[0], PAD, umv[0], umv[1], px, py,
                                        pw, ph, self.bd, True)
            return py_, z, z
        if r0 >= 0 and r1 >= 0:  # bi-prediction (spec 8.5.3.3.3)
            f0, f1 = self.refs_l0[r0], self.refs_l1[r1]
            if self.wp_tables is not None:
                # explicit weighted bi-pred (pps weighted_bipred_flag,
                # spec 8.5.3.3.4.3): refs without signalled weights take
                # the defaults w = 1 << denom, o = 0 (which reduce to the
                # default bi rounding) — reference addWeightBi
                from ..ops.interp import mc_predict_bi_wp_np
                ld, cd = self.wp_denoms
                lw0, cw0 = self._wp_of(0, r0)
                lw1, cw1 = self._wp_of(1, r1)
                lw0 = lw0 or (1 << ld, 0)
                lw1 = lw1 or (1 << ld, 0)
                cw0 = cw0 or [(1 << cd, 0), (1 << cd, 0)]
                cw1 = cw1 or [(1 << cd, 0), (1 << cd, 0)]
                py_ = mc_predict_bi_wp_np(
                    f0[0], f1[0], PAD, mv, mv1, px, py, pw, ph,
                    lw0[0], lw0[1], lw1[0], lw1[1], ld, self.bd, True)
                pcb = mc_predict_bi_wp_np(
                    f0[1], f1[1], PAD, mv, mv1, cx, cy, cw, chh,
                    cw0[0][0], cw0[0][1], cw1[0][0], cw1[0][1], cd,
                    self.bd, False, chroma_shift=(csx, csy))
                pcr = mc_predict_bi_wp_np(
                    f0[2], f1[2], PAD, mv, mv1, cx, cy, cw, chh,
                    cw0[1][0], cw0[1][1], cw1[1][0], cw1[1][1], cd,
                    self.bd, False, chroma_shift=(csx, csy))
                return py_, pcb, pcr
            py_ = mc_predict_bi_np(f0[0], f1[0], PAD, mv, mv1,
                                   px, py, pw, ph, self.bd, True)
            pcb = mc_predict_bi_np(f0[1], f1[1], PAD, mv, mv1, cx,
                                   cy, cw, chh, self.bd, False,
                                   chroma_shift=(csx, csy))
            pcr = mc_predict_bi_np(f0[2], f1[2], PAD, mv, mv1, cx,
                                   cy, cw, chh, self.bd, False,
                                   chroma_shift=(csx, csy))
        else:
            umv = mv if r0 >= 0 else mv1
            lx = 0 if r0 >= 0 else 1
            ridx = r0 if r0 >= 0 else r1
            f = self.refs_l0[ridx] if lx == 0 else self.refs_l1[ridx]
            lw, cwts = self._wp_of(lx, ridx)
            if lw is not None:
                py_ = mc_predict_wp_np(f[0], PAD, umv[0], umv[1], px, py,
                                       pw, ph, self.bd, True, lw[0], lw[1],
                                       self.wp_denoms[0])
            else:
                py_ = mc_predict_np(f[0], PAD, umv[0], umv[1], px, py,
                                    pw, ph, self.bd, True)
            if cwts is not None:
                pcb = mc_predict_wp_np(f[1], PAD, umv[0], umv[1], cx,
                                       cy, cw, chh, self.bd, False,
                                       cwts[0][0], cwts[0][1],
                                       self.wp_denoms[1], chroma_shift=(csx, csy))
                pcr = mc_predict_wp_np(f[2], PAD, umv[0], umv[1], cx,
                                       cy, cw, chh, self.bd, False,
                                       cwts[1][0], cwts[1][1],
                                       self.wp_denoms[1], chroma_shift=(csx, csy))
            else:
                pcb = mc_predict_np(f[1], PAD, umv[0], umv[1], cx,
                                    cy, cw, chh, self.bd, False,
                                    chroma_shift=(csx, csy))
                pcr = mc_predict_np(f[2], PAD, umv[0], umv[1], cx,
                                    cy, cw, chh, self.bd, False,
                                    chroma_shift=(csx, csy))
        return py_, pcb, pcr

    def _recon_inter_cu(self, d, recon, ctu_x0, ctu_y0, x0, y0, log2):
        size = 1 << log2
        lx, ly = x0 - ctu_x0, y0 - ctu_y0
        csx, csy = self.csx, self.csy
        part = int(d.nxn_flag[ly >> 2, lx >> 2])  # pu_rect part codes
        pred_y = np.zeros((size, size), np.int32)
        pred_cb = np.zeros((size >> csy, size >> csx), np.int32)
        pred_cr = np.zeros((size >> csy, size >> csx), np.int32)
        npu = 1 if part == 0 else 2
        for pu in range(npu):
            ox, oy, pw, ph = _pu_rect(part, pu, size)
            px, py = x0 + ox, y0 + oy
            py_, pcb, pcr = self._pu_pred(d, ctu_x0, ctu_y0, px, py, pw, ph,
                                          x0, y0)
            pred_y[py - y0:py - y0 + ph, px - x0:px - x0 + pw] = py_
            pred_cb[(py - y0) >> csy:((py - y0) >> csy) + (ph >> csy),
                    (px - x0) >> csx:((px - x0) >> csx) + (pw >> csx)] = pcb
            pred_cr[(py - y0) >> csy:((py - y0) >> csy) + (ph >> csy),
                    (px - x0) >> csx:((px - x0) >> csx) + (pw >> csx)] = pcr
        # residual per TU leaf (tu_depth map was filled by the parser)
        for (tx, ty, tlog2, tdepth, blk) in tu_leaves(
                d.tu_depth, x0, y0, log2, ctu_x0, ctu_y0, intra_split=False,
                max_tu_depth_intra=self.sps.max_transform_hierarchy_depth_inter):
            tsize = 1 << tlog2
            tlx, tly = tx - ctu_x0, ty - ctu_y0
            py = pred_y[ty - y0:ty - y0 + tsize, tx - x0:tx - x0 + tsize]
            ts_y = self._ts_of(d, tlx, tly, 0x10)
            r_y = self._add_resid(
                recon, py, tx, ty, tsize, 0,
                d.coeff_y[tly:tly + tsize, tlx:tlx + tsize], ts=ts_y,
                rdpcm=self._erdpcm(d, tlx, tly, 0)
                if (ts_y or self._cu_bypass) else 0)
            if csx == 0:
                # 4:4:4: full-size chroma TB per luma leaf
                cyy, cxx = ty - y0, tx - x0
                ts_cb = self._ts_of(d, tlx, tly, 0x20)
                ts_cr = self._ts_of(d, tlx, tly, 0x40)
                self._add_resid(
                    recon, pred_cb[cyy:cyy + tsize, cxx:cxx + tsize],
                    tx, ty, tsize, 1,
                    d.coeff_cb[tly:tly + tsize, tlx:tlx + tsize],
                    ts=ts_cb,
                    rdpcm=self._erdpcm(d, tlx, tly, 1)
                    if (ts_cb or self._cu_bypass) else 0,
                    ccp_alpha=self._ccp_of(d, tlx, tly, 1),
                    luma_resi=r_y)
                self._add_resid(
                    recon, pred_cr[cyy:cyy + tsize, cxx:cxx + tsize],
                    tx, ty, tsize, 2,
                    d.coeff_cr[tly:tly + tsize, tlx:tlx + tsize],
                    ts=ts_cr,
                    rdpcm=self._erdpcm(d, tlx, tly, 2)
                    if (ts_cr or self._cu_bypass) else 0,
                    ccp_alpha=self._ccp_of(d, tlx, tly, 2),
                    luma_resi=r_y)
            elif self.sps.chroma_format_idc == 0:
                continue  # monochrome: no chroma residual
            elif self.sps.chroma_format_idc == 2:
                # 4:2:2: two square chroma sub-TBs per luma TB (or per
                # blk-3 parent), stacked vertically in the full-height
                # chroma plane
                if tlog2 > 2:
                    bx, by, blog2 = tx, ty, tlog2
                elif blk == 3:
                    bx, by = tx - (1 << tlog2), ty - (1 << tlog2)
                    blog2 = tlog2 + 1
                else:
                    continue
                csz = 1 << (blog2 - 1)
                blx = bx - ctu_x0
                for half in range(2):
                    hy = by + half * csz        # luma == chroma row
                    hly = hy - ctu_y0
                    cyy, cxx = hy - y0, (bx - x0) >> 1
                    ts_cb4 = csz == 4 and self._ts_of(d, blx, hly, 0x20)
                    ts_cr4 = csz == 4 and self._ts_of(d, blx, hly, 0x40)
                    self._add_resid(
                        recon, pred_cb[cyy:cyy + csz, cxx:cxx + csz],
                        bx >> 1, hy, csz, 1,
                        d.coeff_cb[hly:hly + csz, blx >> 1:(blx >> 1) + csz],
                        ts=ts_cb4,
                        rdpcm=self._erdpcm(d, blx, hly, 1)
                        if (ts_cb4 or self._cu_bypass) else 0)
                    self._add_resid(
                        recon, pred_cr[cyy:cyy + csz, cxx:cxx + csz],
                        bx >> 1, hy, csz, 2,
                        d.coeff_cr[hly:hly + csz, blx >> 1:(blx >> 1) + csz],
                        ts=ts_cr4,
                        rdpcm=self._erdpcm(d, blx, hly, 2)
                        if (ts_cr4 or self._cu_bypass) else 0)
            elif tlog2 > 2:
                csz = tsize >> 1
                cyy, cxx = (ty - y0) >> 1, (tx - x0) >> 1
                ts_cb2 = csz == 4 and self._ts_of(d, tlx, tly, 0x20)
                ts_cr2 = csz == 4 and self._ts_of(d, tlx, tly, 0x40)
                self._add_resid(
                    recon, pred_cb[cyy:cyy + csz, cxx:cxx + csz],
                    tx >> 1, ty >> 1, csz, 1,
                    d.coeff_cb[tly >> 1:(tly >> 1) + csz,
                               tlx >> 1:(tlx >> 1) + csz],
                    ts=ts_cb2,
                    rdpcm=self._erdpcm(d, tlx, tly, 1)
                    if (ts_cb2 or self._cu_bypass) else 0)
                self._add_resid(
                    recon, pred_cr[cyy:cyy + csz, cxx:cxx + csz],
                    tx >> 1, ty >> 1, csz, 2,
                    d.coeff_cr[tly >> 1:(tly >> 1) + csz,
                               tlx >> 1:(tlx >> 1) + csz],
                    ts=ts_cr2,
                    rdpcm=self._erdpcm(d, tlx, tly, 2)
                    if (ts_cr2 or self._cu_bypass) else 0)
            elif blk == 3:
                # 8x8 TU split into 4x4 lumas: the single 4x4 chroma TB
                # rides the last child, placed at the parent origin
                # (spec 7.3.8.8 — same structure as the intra path)
                bx, by = tx - (1 << tlog2), ty - (1 << tlog2)
                blx, bly = bx - ctu_x0, by - ctu_y0
                cyy, cxx = (by - y0) >> 1, (bx - x0) >> 1
                ts_cb3 = self._ts_of(d, blx, bly, 0x20)
                ts_cr3 = self._ts_of(d, blx, bly, 0x40)
                self._add_resid(
                    recon, pred_cb[cyy:cyy + 4, cxx:cxx + 4],
                    bx >> 1, by >> 1, 4, 1,
                    d.coeff_cb[bly >> 1:(bly >> 1) + 4,
                               blx >> 1:(blx >> 1) + 4],
                    ts=ts_cb3,
                    rdpcm=self._erdpcm(d, blx, bly, 1)
                    if (ts_cb3 or self._cu_bypass) else 0)
                self._add_resid(
                    recon, pred_cr[cyy:cyy + 4, cxx:cxx + 4],
                    bx >> 1, by >> 1, 4, 2,
                    d.coeff_cr[bly >> 1:(bly >> 1) + 4,
                               blx >> 1:(blx >> 1) + 4],
                    ts=ts_cr3,
                    rdpcm=self._erdpcm(d, blx, bly, 2)
                    if (ts_cr3 or self._cu_bypass) else 0)
