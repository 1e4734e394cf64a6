"""Top-level decoder: Annex-B in, YUV frames out, hash verification.

Parity: reference TDecTop (NAL-at-a-time decode state machine,
TDecTop.cpp:698) + TDecGop::filterPicture's decoded-picture-hash
conformance check (TDecGop.cpp:209) + TAppDecTop::xWriteOutput output
bumping (TAppDecTop.cpp:262 — hold pictures until more than
sps_max_num_reorder_pics are waiting, then emit in POC order).
Decodes general HM-16.4 Main/Main10 streams: full POC-msb derivation
(TDecCAVLC.cpp:1011), multi-slice pictures, reference-list construction
with ref_pic_list_modification and long-term pictures
(TComSlice::setRefPicList), MD5/CRC/checksum hash types, and the
clipMv motion-vector clamp on reconstruction.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.params import PPS, SPS, VPS, crop_conformance_window
from ..core.types import SliceType
from ..entropy import cabac
from ..entropy.nal import nal_to_rbsp, split_annexb
from ..ops.interp import pad_plane
from . import headers as dh
from .recon import PAD, CtuReconstructor

# pictures older than this many POCs below the newest are evicted; covers
# the reference cfgs' deepest RPS delta (-13, encoder_lowdelay_P_main.cfg)
DPB_KEEP = 32


class MissingReferenceError(RuntimeError):
    """A reference picture named by the RPS is absent from the DPB
    (reference TDecTop::xCreateLostPicture trigger)."""


class DecoderTop:
    def __init__(self, collect_stats: bool = False, conceal: bool = False):
        self.vps: Optional[VPS] = None
        self.sps: Optional[SPS] = None
        self.pps: Optional[PPS] = None
        self.collect_stats = collect_stats
        self.conceal = conceal
        self.stats: List[dict] = []   # per-picture analyser records
        # per-syntax-element bit totals (reference TComCodingStatistics)
        from ..entropy.cabac import SYNTAX_STAT_NAMES
        self.syntax_bits = np.zeros(len(SYNTAX_STAT_NAMES), np.uint64)
        # total TBs decoded with a residual-DPCM on-flag (explicit flag
        # bits 0x01/0x04/0x10 of the parser's per-4x4 rext map) — lets
        # tests assert the RDPCM coding tools were actually exercised
        self.rdpcm_tb_count = 0
        self.dpb: Dict[int, List[np.ndarray]] = {}    # poc -> recon planes
        self.dpb_lt: Dict[int, bool] = {}             # poc -> is long-term
        self.dpb_motion: Dict[int, dict] = {}         # poc -> motion field
        self.out_buf: List[Tuple[int, int, List[np.ndarray]]] = []
        self.cvs = 0
        self.hash_status: List[str] = []
        self.pic_structs = []  # pic_timing SEI per AU (field weaving)
        self._last_decoded = None
        self.prev_tid0_poc = 0
        self._pic = None       # in-progress picture accumulator
        # stream-level byte accounting (reference TComCodingStatistics
        # NAL_UNIT_* rows): per-NAL-type raw bytes (incl. emulation
        # prevention + NAL header) and start-code bytes, so the analyser
        # totals reconcile with the file size
        self.nal_bytes: Dict[int, int] = {}
        self.start_code_bytes = 0
        self.slice_header_bits = 0

    def decode_stream(self, data: bytes) -> Iterator[List[np.ndarray]]:
        """Yields decoded frames (lists of planes) in output order."""
        acct_pos = 0
        for nal in split_annexb(data):
            nal_type, tid, rbsp = nal_to_rbsp(nal)
            self.nal_bytes[nal_type] = \
                self.nal_bytes.get(nal_type, 0) + len(nal)
            acct_pos += len(nal)
            if nal_type == 32:
                self._finalize_picture()
                self.vps = dh.parse_vps(rbsp)
            elif nal_type == 33:
                self._finalize_picture()
                self.sps = dh.parse_sps(rbsp)
            elif nal_type == 34:
                self._finalize_picture()
                self.pps = dh.parse_pps(rbsp)
            elif nal_type == 39 or nal_type == 40:
                # a PREFIX SEI between slice segments belongs to the
                # CURRENT access unit (decoding_unit_info SEIs under DU
                # HRD, reference TEncGOP::xWriteDuSEIMessages inserts
                # them before each DU's first VCL NAL) — only finalize
                # when the in-progress picture is already complete
                if nal_type == 40 or self._pic_complete():
                    self._finalize_picture()
                digests, hash_type = self._parse_hash_sei(rbsp)
                if digests and self._last_decoded is not None:
                    dec = self._last_decoded
                    if self.sps and self.sps.chroma_format_idc == 0:
                        dec = dec[:1]  # hash covers the luma plane only
                    ok = self._check_hash(dec, digests, hash_type)
                    self.hash_status.append("OK" if ok else "ERROR")
                from ..entropy.sei import parse_sei_messages, PIC_TIMING
                for (ptype, body) in parse_sei_messages(rbsp):
                    if ptype == PIC_TIMING and body:
                        # pic_struct u(4) is the first field (D.2.3)
                        self.pic_structs.append(body[0] >> 4)
            elif nal_type <= 21:  # VCL
                sh, offset = dh.parse_slice_header(
                    rbsp, nal_type, self.sps, self.pps,
                    prev_tid0_poc=self.prev_tid0_poc)
                self.slice_header_bits += offset * 8
                sh.temporal_id = tid
                if sh.dependent_slice_segment_flag:
                    # inherit every slice parameter from the preceding
                    # segment of this slice (spec 7.3.6.1; reference
                    # TDecSlice copySliceInfo) — shallow copy keeps the
                    # parsed extras (lt_pocs, wp_tables, ...) too
                    import copy as _copy
                    parent = self._pic["slices"][-1][0]
                    addr = sh.slice_segment_address
                    entries = sh.entry_point_offsets
                    sh = _copy.copy(parent)
                    sh.dependent_slice_segment_flag = 1
                    sh.first_slice_segment_in_pic_flag = 0
                    sh.slice_segment_address = addr
                    sh.entry_point_offsets = entries
                if sh.first_slice_segment_in_pic_flag:
                    self._finalize_picture()
                    if nal_type in (16, 17, 18, 19, 20):
                        # IRAP with DPB reset (IDR/BLA): flush + clear
                        yield from self._bump(all_pics=True)
                        self.dpb = {}
                        self.dpb_lt = {}
                        self.dpb_motion = {}
                        self.cvs += 1
                    self._start_picture(sh)
                try:
                    self._decode_slice_into(sh, rbsp, offset)
                except MissingReferenceError as e:
                    if not self.conceal:
                        raise
                    # lost-picture concealment (reference
                    # TDecTop::xCreateLostPicture:223): substitute the
                    # closest DPB picture and keep decoding
                    import sys
                    print(f"warning: {e}; concealing", file=sys.stderr)
                    self._conceal_missing_refs(sh)
                    self._decode_slice_into(sh, rbsp, offset)
                # picture-level output happens at finalize
                yield from self._bump(all_pics=False)
        self._finalize_picture()
        yield from self._bump(all_pics=True)

    def _bump(self, all_pics: bool) -> Iterator[List[np.ndarray]]:
        limit = 0 if all_pics else (
            self.sps.sps_max_num_reorder_pics if self.sps else 0)
        self.out_buf.sort(key=lambda t: (t[0], t[1]))
        mono = self.sps is not None and self.sps.chroma_format_idc == 0
        while len(self.out_buf) > limit:
            planes = self.out_buf.pop(0)[2]
            # output cropping to the SPS conformance window (reference
            # TAppDecTop xWriteOutput / TVideoIOYuv::write conf offsets);
            # the DPB and picture hashes stay full-size
            if self.sps is not None:
                planes = crop_conformance_window(planes, self.sps)
            # monochrome output carries the luma plane only (the DPB
            # keeps placeholder chroma arrays internally)
            yield planes[:1] if mono else planes

    # ------------------------------------------------------------------
    def _parse_hash_sei(self, rbsp: bytes):
        from ..entropy.sei import parse_sei_messages, DECODED_PICTURE_HASH
        for (ptype, body) in parse_sei_messages(rbsp):
            if ptype == DECODED_PICTURE_HASH and body:
                hash_type = body[0]
                per = {0: 16, 1: 2, 2: 4}.get(hash_type)
                if per is None:
                    return None, None
                digests = [body[1 + i:1 + i + per]
                           for i in range(0, len(body) - 1, per)]
                return digests, hash_type
        return None, None

    def _check_hash(self, planes, digests, hash_type) -> bool:
        from ..entropy.sei import picture_hash
        ours = picture_hash(planes, self.sps.bit_depth_luma, hash_type)
        return (len(ours) == len(digests)
                and all(a == b for a, b in zip(ours, digests)))

    # ------------------------------------------------------------------
    def _ref_lists(self, sh) -> Tuple[List[int], List[int], List[bool]]:
        """Final L0/L1 reference POC lists (spec 8.3.4; reference
        TComSlice::setRefPicList — temp list st0/st1/lt cyclically
        extended, then ref_pic_list_modification entries applied).
        Returns (l0, l1, lt_flags_by_temp_idx)."""
        if sh.slice_type == SliceType.I or sh.rps is None:
            return [], [], []
        st0 = [sh.poc + d for d, u in zip(sh.rps.delta_pocs,
                                          sh.rps.used_flags)
               if d < 0 and u]
        st1 = [sh.poc + d for d, u in zip(sh.rps.delta_pocs,
                                          sh.rps.used_flags)
               if d > 0 and u]
        max_lsb = 1 << (self.sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
        lt = []
        for poc_or_lsb, used, has_msb in zip(sh.lt_pocs, sh.lt_used,
                                             sh.lt_has_msb):
            if not used:
                continue
            if has_msb:
                lt.append(poc_or_lsb)
            else:
                # match by POC lsb in the DPB (spec 8.3.2 "PocLsbLt")
                cand = [p for p in self.dpb
                        if (p & (max_lsb - 1)) == poc_or_lsb]
                lt.append(max(cand) if cand else poc_or_lsb)
        for p in lt:
            self.dpb_lt[p] = True   # keep past DPB_KEEP eviction
        temp0 = st0 + st1 + lt
        temp1 = st1 + st0 + lt
        n_total = len(temp0)
        if n_total == 0:
            return [], [], []
        is_lt = [i >= len(st0) + len(st1) for i in range(n_total)]
        n0, n1 = sh.num_ref_idx_active
        ent0 = sh.list_entries[0]
        ent1 = sh.list_entries[1]
        l0 = [temp0[ent0[r] if ent0 else r % n_total] for r in range(n0)]
        l1 = ([temp1[ent1[r] if ent1 else r % n_total] for r in range(n1)]
              if sh.slice_type == SliceType.B else [])
        return l0, l1, is_lt

    def _start_picture(self, sh) -> None:
        sps = self.sps
        w, h = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
        sx, sy = sps.chroma_shift_x, sps.chroma_shift_y
        # sample dtype: int16 through 14-bit, int32 for 16-bit video
        pdt = np.int16 if sps.bit_depth_luma <= 14 else np.int32
        recon = [np.zeros((h, w), pdt),
                 np.zeros((h >> sy, w >> sx), pdt),
                 np.zeros((h >> sy, w >> sx), pdt)]
        ctus_w = sps.pic_width_in_ctus
        ctus_h = sps.pic_height_in_ctus
        self._pic = {
            "sh0": sh, "recon": recon,
            "decisions": [None] * (ctus_w * ctus_h),
            "slices": [],         # (sh, first_ctu_idx, n_ctus) per slice
            "qp_pred": None, "qp_fin": None,
            "ref_l0": [], "ref_l1": [],
        }

    def _conceal_missing_refs(self, sh) -> None:
        l0, l1, _ = self._ref_lists(sh)
        for rp in set(l0 + l1):
            if rp not in self.dpb:
                if not self.dpb:
                    raise MissingReferenceError(
                        f"no pictures available to conceal POC {rp}")
                closest = min(self.dpb, key=lambda p: abs(p - rp))
                self.dpb[rp] = [p.copy() for p in self.dpb[closest]]

    def _decode_slice_into(self, sh, rbsp: bytes, offset: int) -> None:
        sps, pps = self.sps, self.pps
        slice_data = rbsp[offset:]
        ref_pocs_l0, ref_pocs_l1, _ = self._ref_lists(sh)
        nl0 = max(1, sh.num_ref_idx_active[0])
        nl1 = (sh.num_ref_idx_active[1]
               if sh.slice_type == SliceType.B else 0)
        sp = cabac.make_slice_params(
            sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples,
            sh.slice_qp, slice_type=int(sh.slice_type),
            ctu_size=sps.ctu_size,
            max_tu_depth_intra=sps.max_transform_hierarchy_depth_intra,
            max_tu_depth_inter=sps.max_transform_hierarchy_depth_inter,
            chroma_format=sps.chroma_format_idc,
            amp=sps.amp_enabled_flag,
            scaling_lists=sps.scaling_list_enabled_flag,
            transform_skip=pps.transform_skip_enabled_flag,
            cu_dqp=pps.cu_qp_delta_enabled_flag,
            dqp_depth=pps.diff_cu_qp_delta_depth,
            pcm=sps.pcm_enabled_flag,
            sign_hiding=pps.sign_data_hiding_enabled_flag,
            max_merge_cand=5 - sh.five_minus_max_num_merge_cand,
            cabac_init=sh.cabac_init_flag,
            col_from_l0=sh.collocated_from_l0_flag,
            slice_start_ctu=sh.slice_segment_address,
            num_ref_l0=nl0, num_ref_l1=nl1,
            mvd_l1_zero=sh.mvd_l1_zero_flag,
            ref_poc_l0=ref_pocs_l0[:16], ref_poc_l1=ref_pocs_l1[:16],
            sao_luma=sh.slice_sao_luma_flag,
            sao_chroma=sh.slice_sao_chroma_flag,
            bit_depth=sps.bit_depth_luma, cur_poc=sh.poc,
            tile_cols=pps.num_tile_columns_minus1 + 1
            if pps.tiles_enabled_flag else 0,
            tile_rows=pps.num_tile_rows_minus1 + 1
            if pps.tiles_enabled_flag else 0)
        sp.wpp = pps.entropy_coding_sync_enabled_flag
        # range extensions (sps_range_extension / pps_range_extension)
        sp.ts_rotation = sps.transform_skip_rotation_enabled_flag
        sp.ts_context = sps.transform_skip_context_enabled_flag
        sp.implicit_rdpcm = sps.implicit_rdpcm_enabled_flag
        sp.explicit_rdpcm = sps.explicit_rdpcm_enabled_flag
        sp.persistent_rice = sps.persistent_rice_adaptation_enabled_flag
        sp.bypass_align = sps.cabac_bypass_alignment_enabled_flag
        sp.ccp = pps.cross_component_prediction_enabled_flag
        sp.ts_max_log2 = (2 + pps.log2_max_transform_skip_block_size_minus2
                          if pps.transform_skip_enabled_flag else 2)
        sp.tq_bypass = pps.transquant_bypass_enabled_flag
        sp.cip = pps.constrained_intra_pred_flag
        sp.log2_par_merge = pps.log2_parallel_merge_level_minus2 + 2
        if sh.dependent_slice_segment_flag and self._pic.get("sdec"):
            # dependent segment: the open decoder continues with its
            # CABAC contexts / neighbour maps / dQP chain intact
            sdec = self._pic["sdec"]
            sdec.reseat(slice_data)
        else:
            sdec = cabac.SliceDataDecoder(sp, slice_data)
            if self.collect_stats:
                sdec.enable_stats()
            self._pic["sdec"] = sdec
            self._pic["slice_start"] = sh.slice_segment_address
        if sh.slice_temporal_mvp_enabled_flag and \
                not sh.dependent_slice_segment_flag:
            col_list = (ref_pocs_l0 if sh.collocated_from_l0_flag
                        else ref_pocs_l1)
            if (col_list and sh.collocated_ref_idx < len(col_list)
                    and col_list[sh.collocated_ref_idx]
                    in self.dpb_motion):
                cabac.set_collocated(
                    sdec,
                    self.dpb_motion[col_list[sh.collocated_ref_idx]],
                    False)
        if ((pps.entropy_coding_sync_enabled_flag
             or pps.tiles_enabled_flag) and sh.entry_point_offsets):
            # map NAL-payload entry offsets (incl. emulation prevention)
            # back to raw positions within the unescaped slice data; the
            # escape scanner's zero-run state carries in from the header
            targets = []
            acc = 0
            for o in sh.entry_point_offsets:
                acc += o
                targets.append(acc)
            zeros = 0
            for b in rbsp[:offset]:
                if zeros >= 2 and b <= 3:
                    zeros = 0
                zeros = zeros + 1 if b == 0 else 0
            raw_offs = []
            esc = 0
            ti = 0
            for i, b in enumerate(slice_data):
                if ti < len(targets) and esc == targets[ti]:
                    raw_offs.append(i)
                    ti += 1
                if zeros >= 2 and b <= 3:
                    esc += 1
                    zeros = 0
                esc += 1
                zeros = zeros + 1 if b == 0 else 0
            sdec.set_entry_points(raw_offs)
        w, h = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
        refs_l0 = refs_l1 = None
        if sh.slice_type != SliceType.I:
            def resolve(pocs, n):
                out = []
                for rp in pocs[:n]:
                    if rp not in self.dpb:
                        raise MissingReferenceError(
                            f"missing reference POC {rp}")
                    out.append([pad_plane(p, PAD) for p in self.dpb[rp]])
                return out
            refs_l0 = resolve(ref_pocs_l0, nl0)
            refs_l1 = resolve(ref_pocs_l1, nl1) if nl1 else None
        sps._tile_cols = (pps.num_tile_columns_minus1 + 1
                          if pps.tiles_enabled_flag else 0)
        sps._tile_rows = (pps.num_tile_rows_minus1 + 1
                          if pps.tiles_enabled_flag else 0)
        sps._scaling_data = (pps.scaling_list_data
                             if pps.scaling_list_data is not None
                             else sps.scaling_list_data)
        wp_tables = getattr(sh, "wp_tables", None)
        wp = ((sh.wp_log2_denom, sh.wp_weight, sh.wp_offset)
              if (wp_tables is None and getattr(sh, "wp_luma_flag", 0))
              else None)
        cip_map = None
        if pps.constrained_intra_pred_flag:
            # picture-lifetime intra/inter map (4x4 luma granularity) so
            # constrained intra prediction sees blocks from every slice
            # segment of the picture decoded so far
            cip_map = self._pic.setdefault(
                "cip_map", np.zeros(((h + 3) >> 2, (w + 3) >> 2), bool))
        rc = CtuReconstructor(
            sps, sh.slice_qp, refs_l0, refs_l1, wp=wp,
            wp_tables=wp_tables,
            wp_denoms=(getattr(sh, "wp_log2_denom", 6),
                       getattr(sh, "wp_chroma_log2_denom", 6)),
            slice_start_ctu=(self._pic.get("slice_start", 0)
                             if sh.dependent_slice_segment_flag
                             else sh.slice_segment_address),
            cb_qp_offset=pps.pps_cb_qp_offset
            + getattr(sh, "slice_cb_qp_offset", 0),
            cr_qp_offset=pps.pps_cr_qp_offset
            + getattr(sh, "slice_cr_qp_offset", 0),
            cip_map=cip_map)
        ctus_w = sps.pic_width_in_ctus
        from ..entropy.cabac import tile_scan_order
        order = tile_scan_order(
            w, h, sps.ctu_size,
            pps.num_tile_columns_minus1 + 1 if pps.tiles_enabled_flag else 0,
            pps.num_tile_rows_minus1 + 1 if pps.tiles_enabled_flag else 0)
        pic = self._pic
        recon = pic["recon"]
        decisions = pic["decisions"]
        dqp_on = pps.cu_qp_delta_enabled_flag
        assert not dqp_on or sh.slice_segment_address == 0, \
            "cu_qp_delta with multi-slice pictures unsupported"
        # slice_segment_address is a raster-scan CTB address (spec
        # 7.4.7.1); decoding walks the TILE scan — convert (reference
        # TComPicSym CtuRsToTsAddrMap)
        start = sh.slice_segment_address
        if pps.tiles_enabled_flag and start:
            sx, sy = start % ctus_w, start // ctus_w
            start = order.index((sx, sy))
        n_done = 0
        recon_q = []
        for k in range(start, len(order)):
            cx, cy = order[k]
            d, eos = sdec.decode_ctu(cx, cy)
            qp4 = None
            if dqp_on:
                # per-4x4 QP map: sub-CTU quantization groups
                # (diff_cu_qp_delta_depth > 0) vary QP inside the CTU
                qp4 = cabac.fetch_ctu_qp4(sdec, sps.ctu_size)
                pic.setdefault("qp4", {})[(cx, cy)] = qp4
            rc.recon_ctu(d, cx, cy, recon, qp4=qp4)
            decisions[cy * ctus_w + cx] = d
            n_done += 1
            if eos:
                break
        assert start + n_done <= len(order)
        if start + n_done == len(order):
            assert eos == 1, "end_of_slice missing at final CTU"
        if self.collect_stats:
            cur = sdec.stat_bits()
            prev = getattr(sdec, "_stats_taken", None)
            self.syntax_bits = self.syntax_bits + (
                cur if prev is None else cur - prev)
            sdec._stats_taken = cur
        pic["slices"].append((sh, start, n_done))
        pic["bytes"] = pic.get("bytes", 0) + len(slice_data)
        pic["ref_l0"], pic["ref_l1"] = ref_pocs_l0[:nl0], ref_pocs_l1[:nl1]

    def _pic_complete(self) -> bool:
        """True when no picture is in progress or every CTU of the
        current picture has been covered by a decoded slice."""
        pic = self._pic
        if pic is None:
            return True
        covered = sum(n for (_s, _a, n) in pic["slices"])
        return covered == len(pic["decisions"])

    def _finalize_picture(self) -> None:
        """Deblock + SAO + DPB/output bookkeeping once every slice of the
        current picture has been decoded (reference
        TDecTop::executeLoopFilters / TDecGop::filterPicture)."""
        pic, self._pic = self._pic, None
        if pic is None:
            return
        sps, pps = self.sps, self.pps
        sh = pic["sh0"]
        recon = pic["recon"]
        decisions = pic["decisions"]
        covered = sum(n for (_s, _a, n) in pic["slices"])
        assert covered == len(decisions) and all(
            d is not None for d in decisions), \
            f"picture POC {sh.poc} incomplete: {covered}/{len(decisions)}"
        w, h = sps.pic_width_in_luma_samples, sps.pic_height_in_luma_samples
        ctus_w = sps.pic_width_in_ctus
        from ..entropy.cabac import tile_scan_order
        order = tile_scan_order(
            w, h, sps.ctu_size,
            pps.num_tile_columns_minus1 + 1 if pps.tiles_enabled_flag else 0,
            pps.num_tile_rows_minus1 + 1 if pps.tiles_enabled_flag else 0)
        if sps.sps_temporal_mvp_enabled_flag:
            self.dpb_motion[sh.poc] = cabac.motion_field(
                decisions, sps, pic["ref_l0"], pic["ref_l1"], sh.poc)
        # cu_transquant_bypass samples are NOT modified by the in-loop
        # filters (spec 8.7.2.5.4 nDp/nDq = 0 and 8.7.3 SAO skip):
        # snapshot them and restore after deblock + SAO
        if sps.explicit_rdpcm_enabled_flag or \
                sps.implicit_rdpcm_enabled_flag:
            for dd in decisions:
                rx = getattr(dd, "rext", None)
                if rx is not None:
                    self.rdpcm_tb_count += int(
                        np.count_nonzero(rx & 0x15))
        byp_saved = None
        if pps.transquant_bypass_enabled_flag:
            h4, w4 = -(-h // 4), -(-w // 4)
            n4 = sps.ctu_size // 4
            byp4 = np.zeros((h4, w4), bool)
            for k, (bcx, bcy) in enumerate(order):
                rx = getattr(decisions[bcy * ctus_w + bcx], "rext", None)
                if rx is not None:
                    y0b, x0b = bcy * n4, bcx * n4
                    byp4[y0b:y0b + n4, x0b:x0b + n4] |= \
                        (rx[:h4 - y0b, :w4 - x0b] & 0x40) != 0
            if byp4.any():
                mask_y = np.repeat(np.repeat(byp4, 4, 0), 4, 1)[:h, :w]
                byp_saved = (mask_y, [p.copy() for p in recon])
        if not sh.slice_deblocking_filter_disabled_flag:
            qmap = None
            if pps.cu_qp_delta_enabled_flag and pic.get("qp4"):
                # assemble the frame per-4x4 QP map from the per-CTU
                # quantization-group maps recorded during parsing
                h4, w4 = -(-h // 4), -(-w // 4)
                n4 = sps.ctu_size // 4
                qmap = np.full((h4, w4), sh.slice_qp, np.int32)
                for (cx, cy), tile in pic["qp4"].items():
                    y0, x0 = cy * n4, cx * n4
                    qmap[y0:y0 + n4, x0:x0 + n4] = \
                        tile[:h4 - y0, :w4 - x0]
            recon = cabac.deblock_frame_native(
                recon, decisions, sps, sh.slice_qp,
                (pic["ref_l0"], pic["ref_l1"]),
                sh.slice_beta_offset_div2, sh.slice_tc_offset_div2,
                qp_map=qmap, cb_qp_offset=pps.pps_cb_qp_offset,
                cr_qp_offset=pps.pps_cr_qp_offset)
        if sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag:
            if sps.chroma_format_idc == 1:
                from ..entropy.cabac import sao_apply_native
                recon = sao_apply_native(recon,
                                         [d.sao for d in decisions],
                                         sps, sps.bit_depth_luma)
            else:
                from ..ops import sao as saolib
                recon = saolib.apply_sao(recon, [d.sao for d in decisions],
                                         sps, sps.bit_depth_luma)
        if byp_saved is not None:
            mask_y, saved = byp_saved
            recon[0][mask_y] = saved[0][mask_y]
            sx, sy = sps.chroma_shift_x, sps.chroma_shift_y
            cmask = mask_y[::1 << sy, ::1 << sx]
            for ci in (1, 2):
                recon[ci][cmask] = saved[ci][cmask]
        if self.collect_stats:
            self._collect(sh, decisions, pic.get("bytes", 0))
        self._last_decoded = recon
        self.dpb[sh.poc] = recon
        # track prevTid0Poc (spec 8.3.1: TemporalId 0, not RASL/RADL/SLNR)
        if sh.temporal_id == 0 and sh.nal_unit_type not in (6, 7, 8, 9):
            self.prev_tid0_poc = sh.poc
        lt_keep = {p for p, f in self.dpb_lt.items() if f}
        for old in [p for p in self.dpb
                    if p < sh.poc - DPB_KEEP and p not in lt_keep]:
            del self.dpb[old]
        self.out_buf.append((self.cvs, sh.poc, recon))

    def _collect(self, sh, decisions, data_bytes):
        """Per-picture analyser record (reference TAppDecAnalyser-style
        statistics: CU mode shares, MV field summary, coefficient counts)."""
        rec = {"poc": sh.poc, "type": sh.slice_type.name,
               "qp": sh.slice_qp, "slice_bytes": data_bytes,
               "skip4": 0, "merge4": 0, "intra4": 0, "inter4": 0,
               "coeff_y": 0, "coeff_c": 0, "depth_hist": [0, 0, 0, 0],
               "abs_mv_sum": 0, "mv_blocks": 0}
        for d in decisions:
            rec["skip4"] += int(d.skip_flag.sum())
            rec["merge4"] += int((d.merge_flag & (1 - d.skip_flag)).sum())
            rec["intra4"] += int((d.pred_mode == 1).sum())
            rec["inter4"] += int((d.pred_mode == 0).sum())
            rec["coeff_y"] += int((d.coeff_y != 0).sum())
            rec["coeff_c"] += int((d.coeff_cb != 0).sum()
                                  + (d.coeff_cr != 0).sum())
            for dep in range(4):
                rec["depth_hist"][dep] += int((d.cu_depth == dep).sum())
            inter = d.pred_mode == 0
            rec["abs_mv_sum"] += int((np.abs(d.mv_x[inter])
                                      + np.abs(d.mv_y[inter])).sum())
            rec["mv_blocks"] += int(inter.sum())
            rec["bi4"] = rec.get("bi4", 0) + int(
                (inter & (d.ref_idx >= 0) & (d.ref_idx1 >= 0)).sum())
        self.stats.append(rec)
