"""Parameter-set and slice-header parsers (spec 7.3.2/7.3.6).

Parity: reference TDecCAVLC.cpp (parseVPS/parseSPS/parsePPS/
parseSliceHeader), restricted to the feature subset this framework emits
(asserting loudly on unsupported tools so gaps surface instead of
corrupting).
"""
from __future__ import annotations

from ..core.params import (PPS, SPS, VPS, ProfileTierLevel, ScalingListData,
                           ShortTermRPS, SliceHeader)
from ..core.types import SliceType
from ..entropy.bitreader import BitReader


def _parse_scaling_list_data(br: BitReader) -> ScalingListData:
    """scaling_list_data (spec 7.3.4; reference TDecCavlc::
    parseScalingList/xDecodeScalingList): per (sizeId, listId) either a
    copy/default reference or DPCM-coded coefficients in diagonal scan;
    HM derives the 32x32 chroma entries from 16x16."""
    import numpy as np
    from ..core import tables
    sld = ScalingListData()
    for size_id in range(4):
        for list_id in range(6):
            if size_id == 3 and list_id % 3 != 0:
                sld.lists[3][list_id] = sld.lists[2][list_id].copy()
                sld.dc[3][list_id] = sld.dc[2][list_id]
                continue
            if not br.flag():           # scaling_list_pred_mode_flag == 0
                delta = br.ue()         # scaling_list_pred_matrix_id_delta
                if size_id == 3:
                    delta *= 3
                ref = list_id - delta
                if ref == list_id:      # delta 0: spec default matrix
                    sld.set_default(size_id, list_id)
                else:
                    sld.lists[size_id][list_id] = \
                        sld.lists[size_id][ref].copy()
                    sld.dc[size_id][list_id] = (
                        sld.dc[size_id][ref] if size_id >= 2 else 16)
            else:                       # DPCM mode
                n = 4 if size_id == 0 else 8
                next_coef = 8
                if size_id > 1:
                    next_coef = br.se() + 8   # scaling_list_dc_coef_minus8
                    sld.dc[size_id][list_id] = next_coef
                dst = np.zeros(n * n, np.int32)
                scan = tables.diag_scan(n)
                for i in range(n * n):
                    next_coef = (next_coef + br.se() + 256) % 256
                    x, y = scan[i]
                    dst[y * n + x] = next_coef
                sld.lists[size_id][list_id] = dst
    return sld


def _parse_profile_tier(br: BitReader, ptl) -> None:
    """One profile_tier() structure, 88 bits (spec 7.3.3; reference
    TDecCAVLC parseProfileTier:1550). ptl may be None for sub-layer
    structures we skip."""
    sink = ProfileTierLevel() if ptl is None else ptl
    br.u(2)
    sink.general_tier_flag = br.flag()
    sink.general_profile_idc = br.u(5)
    br.u(32)  # compatibility flags
    sink.general_progressive_source_flag = br.flag()
    sink.general_interlaced_source_flag = br.flag()
    sink.general_non_packed_constraint_flag = br.flag()
    sink.general_frame_only_constraint_flag = br.flag()
    if sink.general_profile_idc in (4, 5):
        sink.general_max_12bit_constraint_flag = br.flag()
        sink.general_max_10bit_constraint_flag = br.flag()
        sink.general_max_8bit_constraint_flag = br.flag()
        sink.general_max_422chroma_constraint_flag = br.flag()
        sink.general_max_420chroma_constraint_flag = br.flag()
        sink.general_max_monochrome_constraint_flag = br.flag()
        sink.general_intra_constraint_flag = br.flag()
        sink.general_one_picture_only_constraint_flag = br.flag()
        sink.general_lower_bit_rate_constraint_flag = br.flag()
        br.u(32)
        br.u(2)   # reserved 34 bits
    else:
        br.u(32)
        br.u(11)  # reserved 43 bits
    br.flag()     # general_reserved_zero_bit


def parse_ptl(br: BitReader, ptl: ProfileTierLevel,
              max_sub_layers_minus1: int = 0) -> None:
    """profile_tier_level() incl. the per-sub-layer structures (spec
    7.3.3; reference TDecCAVLC::parsePTL:1512 — round 1 skipped the
    sub-layer loops, which broke on HM's 4-temporal-layer RA streams)."""
    _parse_profile_tier(br, ptl)
    ptl.general_level_idc = br.u(8)
    sub_profile = []
    sub_level = []
    for _ in range(max_sub_layers_minus1):
        sub_profile.append(br.flag())
        sub_level.append(br.flag())
    if max_sub_layers_minus1 > 0:
        for _ in range(max_sub_layers_minus1, 8):
            br.u(2)  # reserved_zero_2bits
    for i in range(max_sub_layers_minus1):
        if sub_profile[i]:
            _parse_profile_tier(br, None)
        if sub_level[i]:
            br.u(8)  # sub_layer_level_idc


def parse_st_rps(br: BitReader, idx: int, prev: list,
                 in_slice_header: bool = False) -> ShortTermRPS:
    rps = ShortTermRPS()
    if idx != 0:
        pred = br.flag()
        if pred:
            # inter-RPS prediction (spec 7.4.8 st_ref_pic_set with
            # inter_ref_pic_set_prediction_flag; reference TDecCAVLC::
            # parseShortTermRefPicSet): the set is derived from a
            # previously signalled RPS shifted by deltaRps. In a slice
            # header (idx == num_short_term_ref_pic_sets) the reference
            # set is selected by delta_idx_minus1; in the SPS it is
            # always the previous one.
            ref_idx = idx - 1
            if in_slice_header:
                ref_idx = idx - 1 - br.ue()   # delta_idx_minus1
            ref = prev[ref_idx]
            sign = br.flag()
            abs_delta = br.ue() + 1
            delta_rps = (1 - 2 * sign) * abs_delta
            src = list(ref.delta_pocs) + [0]   # + the ref picture itself
            ds, us = [], []
            for j in range(len(src)):
                used = br.flag()
                use_delta = 1 if used else br.flag()
                if used or use_delta:
                    d = src[j] + delta_rps if j < len(src) - 1 \
                        else delta_rps
                    if d != 0:
                        ds.append(d)
                        us.append(1 if used else 0)
            order = sorted(range(len(ds)), key=lambda k: ds[k])
            neg = [k for k in order if ds[k] < 0][::-1]
            pos = [k for k in order if ds[k] > 0]
            rps.delta_pocs = [ds[k] for k in neg] + [ds[k] for k in pos]
            rps.used_flags = [us[k] for k in neg] + [us[k] for k in pos]
            return rps
    num_neg = br.ue()
    num_pos = br.ue()
    deltas, used = [], []
    acc = 0
    for _ in range(num_neg):
        acc -= br.ue() + 1
        deltas.append(acc)
        used.append(br.flag())
    acc = 0
    for _ in range(num_pos):
        acc += br.ue() + 1
        deltas.append(acc)
        used.append(br.flag())
    rps.delta_pocs = deltas
    rps.used_flags = used
    return rps


def parse_vps(rbsp: bytes) -> VPS:
    br = BitReader(rbsp)
    vps = VPS()
    vps.vps_video_parameter_set_id = br.u(4)
    br.u(2)
    br.u(6)
    vps.vps_max_sub_layers_minus1 = br.u(3)
    vps.vps_temporal_id_nesting_flag = br.flag()
    br.u(16)
    parse_ptl(br, vps.ptl, vps.vps_max_sub_layers_minus1)
    sub_info = br.flag()
    for _ in range((vps.vps_max_sub_layers_minus1 + 1) if sub_info else 1):
        # keep the highest sub-layer's values (= the full stream's)
        vps.vps_max_dec_pic_buffering_minus1 = br.ue()
        vps.vps_max_num_reorder_pics = br.ue()
        vps.vps_max_latency_increase_plus1 = br.ue()
    max_layer_id = br.u(6)
    num_layer_sets_minus1 = br.ue()
    for _ in range(num_layer_sets_minus1):
        for _ in range(max_layer_id + 1):
            br.flag()  # layer_id_included_flag
    if br.flag():      # vps_timing_info_present_flag
        br.u(32)       # vps_num_units_in_tick
        br.u(32)       # vps_time_scale
        if br.flag():  # vps_poc_proportional_to_timing_flag
            br.ue()    # vps_num_ticks_poc_diff_one_minus1
        num_hrd = br.ue()
        assert num_hrd == 0, "VPS HRD parameters unsupported"
    return vps  # extension ignored


def parse_sps(rbsp: bytes) -> SPS:
    br = BitReader(rbsp)
    sps = SPS()
    sps.sps_video_parameter_set_id = br.u(4)
    sps.sps_max_sub_layers_minus1 = br.u(3)
    sps.sps_temporal_id_nesting_flag = br.flag()
    parse_ptl(br, sps.ptl, sps.sps_max_sub_layers_minus1)
    sps.sps_seq_parameter_set_id = br.ue()
    sps.chroma_format_idc = br.ue()
    if sps.chroma_format_idc == 3:
        br.flag()
    sps.pic_width_in_luma_samples = br.ue()
    sps.pic_height_in_luma_samples = br.ue()
    sps.conformance_window_flag = br.flag()
    if sps.conformance_window_flag:
        sps.conf_win_left_offset = br.ue()
        sps.conf_win_right_offset = br.ue()
        sps.conf_win_top_offset = br.ue()
        sps.conf_win_bottom_offset = br.ue()
    sps.bit_depth_luma_minus8 = br.ue()
    sps.bit_depth_chroma_minus8 = br.ue()
    sps.log2_max_pic_order_cnt_lsb_minus4 = br.ue()
    sub_info = br.flag()
    for _ in range((sps.sps_max_sub_layers_minus1 + 1) if sub_info else 1):
        sps.sps_max_dec_pic_buffering_minus1 = br.ue()
        sps.sps_max_num_reorder_pics = br.ue()
        sps.sps_max_latency_increase_plus1 = br.ue()
    sps.log2_min_luma_coding_block_size_minus3 = br.ue()
    sps.log2_diff_max_min_luma_coding_block_size = br.ue()
    sps.log2_min_luma_transform_block_size_minus2 = br.ue()
    sps.log2_diff_max_min_luma_transform_block_size = br.ue()
    sps.max_transform_hierarchy_depth_inter = br.ue()
    sps.max_transform_hierarchy_depth_intra = br.ue()
    sps.scaling_list_enabled_flag = br.flag()
    if sps.scaling_list_enabled_flag:
        if br.flag():                   # sps_scaling_list_data_present
            sps.scaling_list_data = _parse_scaling_list_data(br)
    sps.amp_enabled_flag = br.flag()
    sps.sample_adaptive_offset_enabled_flag = br.flag()
    sps.pcm_enabled_flag = br.flag()
    if sps.pcm_enabled_flag:
        sps.pcm_sample_bit_depth_luma_minus1 = br.u(4)
        sps.pcm_sample_bit_depth_chroma_minus1 = br.u(4)
        sps.log2_min_pcm_luma_coding_block_size_minus3 = br.ue()
        sps.log2_diff_max_min_pcm_luma_coding_block_size = br.ue()
        sps.pcm_loop_filter_disabled_flag = br.flag()
        assert sps.log2_min_pcm_luma_coding_block_size_minus3 == 0, \
            "PCM min block size must be 8"
    num_rps = br.ue()
    sps.short_term_rps = []
    for i in range(num_rps):
        sps.short_term_rps.append(parse_st_rps(br, i, sps.short_term_rps))
    sps.long_term_ref_pics_present_flag = br.flag()
    if sps.long_term_ref_pics_present_flag:
        # spec 7.3.2.2: SPS-level long-term reference candidates
        n_lt = br.ue()
        sps._lt_poc_lsb_sps = []
        sps._lt_used_sps = []
        for _ in range(n_lt):
            sps._lt_poc_lsb_sps.append(
                br.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4))
            sps._lt_used_sps.append(br.flag())
    sps.sps_temporal_mvp_enabled_flag = br.flag()
    sps.strong_intra_smoothing_enabled_flag = br.flag()
    sps.vui_parameters_present_flag = br.flag()
    if sps.vui_parameters_present_flag:
        _parse_vui(br, sps)
    # sps_extension (spec 7.3.2.2.1/7.3.2.2.2 sps_range_extension;
    # reference TDecCAVLC::parseSPS RExt block)
    if br.flag():                       # sps_extension_present_flag
        range_ext = br.flag()           # sps_range_extension_flag
        multilayer = br.flag()
        sps_3d = br.flag()
        scc = br.flag()
        br.u(4)                         # sps_extension_4bits
        if range_ext:
            sps.transform_skip_rotation_enabled_flag = br.flag()
            sps.transform_skip_context_enabled_flag = br.flag()
            sps.implicit_rdpcm_enabled_flag = br.flag()
            sps.explicit_rdpcm_enabled_flag = br.flag()
            sps.extended_precision_processing_flag = br.flag()
            sps.intra_smoothing_disabled_flag = br.flag()
            sps.high_precision_offsets_enabled_flag = br.flag()
            sps.persistent_rice_adaptation_enabled_flag = br.flag()
            sps.cabac_bypass_alignment_enabled_flag = br.flag()
        assert not (multilayer or sps_3d or scc), \
            "only the range-extension SPS extension is supported"
    return sps


def _parse_vui(br: BitReader, sps: SPS) -> None:
    """Full vui_parameters parse (spec E.2.1 — every field consumed so
    HRD-carrying streams decode; the optional groups land in
    sps.vui_ext, mirroring entropy/headers.py write_vui)."""
    from ..core.params import VuiExt
    v = sps.vui_ext = VuiExt()
    v.aspect_ratio_info_present_flag = br.flag()
    if v.aspect_ratio_info_present_flag:
        v.aspect_ratio_idc = br.u(8)
        if v.aspect_ratio_idc == 255:  # EXTENDED_SAR
            v.sar_width = br.u(16)
            v.sar_height = br.u(16)
    v.overscan_info_present_flag = br.flag()
    if v.overscan_info_present_flag:
        v.overscan_appropriate_flag = br.flag()
    v.video_signal_type_present_flag = br.flag()
    if v.video_signal_type_present_flag:
        v.video_format = br.u(3)
        v.video_full_range_flag = br.flag()
        v.colour_description_present_flag = br.flag()
        if v.colour_description_present_flag:
            v.colour_primaries = br.u(8)
            v.transfer_characteristics = br.u(8)
            v.matrix_coeffs = br.u(8)
    v.chroma_loc_info_present_flag = br.flag()
    if v.chroma_loc_info_present_flag:
        v.chroma_sample_loc_type_top_field = br.ue()
        v.chroma_sample_loc_type_bottom_field = br.ue()
    v.neutral_chroma_indication_flag = br.flag()
    sps.vui_field_seq_flag = br.flag()
    sps.vui_frame_field_info_present_flag = br.flag()
    v.default_display_window_flag = br.flag()
    if v.default_display_window_flag:
        v.def_disp_win_left_offset = br.ue()
        v.def_disp_win_right_offset = br.ue()
        v.def_disp_win_top_offset = br.ue()
        v.def_disp_win_bottom_offset = br.ue()
    sps.vui_timing_info_present_flag = br.flag()
    if sps.vui_timing_info_present_flag:
        sps.vui_num_units_in_tick = br.u(32)
        sps.vui_time_scale = br.u(32)
        v.poc_proportional_to_timing_flag = br.flag()
        if v.poc_proportional_to_timing_flag:
            v.num_ticks_poc_diff_one_minus1 = br.ue()
        if br.flag():                # vui_hrd_parameters_present
            _parse_hrd(br, sps.sps_max_sub_layers_minus1
                       if hasattr(sps, "sps_max_sub_layers_minus1") else 0)
    v.bitstream_restriction_flag = br.flag()
    if v.bitstream_restriction_flag:
        v.tiles_fixed_structure_flag = br.flag()
        v.motion_vectors_over_pic_boundaries_flag = br.flag()
        v.restricted_ref_pic_lists_flag = br.flag()
        v.min_spatial_segmentation_idc = br.ue()
        v.max_bytes_per_pic_denom = br.ue()
        v.max_bits_per_min_cu_denom = br.ue()
        v.log2_max_mv_length_horizontal = br.ue()
        v.log2_max_mv_length_vertical = br.ue()


def _parse_hrd(br: BitReader, max_sub_layers_minus1: int = 0) -> None:
    """hrd_parameters (spec E.2.2), commonInfPresent = 1."""
    nal_hrd = br.flag()
    vcl_hrd = br.flag()
    sub_pic = 0
    if nal_hrd or vcl_hrd:
        sub_pic = br.flag()
        if sub_pic:
            br.u(8)                  # tick_divisor_minus2
            br.u(5)                  # du_cpb_removal_delay_inc_len_minus1
            br.flag()                # sub_pic_cpb_params_in_pic_timing
            br.u(5)                  # dpb_output_delay_du_length_minus1
        br.u(4)                      # bit_rate_scale
        br.u(4)                      # cpb_size_scale
        if sub_pic:
            br.u(4)                  # cpb_size_du_scale
        br.u(5)                      # initial_cpb_removal_delay_len_minus1
        br.u(5)                      # au_cpb_removal_delay_length_minus1
        br.u(5)                      # dpb_output_delay_length_minus1
    for _ in range(max_sub_layers_minus1 + 1):
        fixed_general = br.flag()
        fixed_within = 1 if fixed_general else br.flag()
        low_delay = 0
        if fixed_within:
            br.ue()                  # elemental_duration_in_tc_minus1
        else:
            low_delay = br.flag()
        cpb_cnt = 0 if low_delay else br.ue()
        for hrd_sel in ((1,) if nal_hrd else ()) +                 ((1,) if vcl_hrd else ()):
            for _ in range(cpb_cnt + 1):
                br.ue()              # bit_rate_value_minus1
                br.ue()              # cpb_size_value_minus1
                if sub_pic:
                    br.ue(); br.ue()
                br.flag()            # cbr_flag


def parse_pps(rbsp: bytes) -> PPS:
    br = BitReader(rbsp)
    pps = PPS()
    pps.pps_pic_parameter_set_id = br.ue()
    pps.pps_seq_parameter_set_id = br.ue()
    pps.dependent_slice_segments_enabled_flag = br.flag()
    pps.output_flag_present_flag = br.flag()
    pps.num_extra_slice_header_bits = br.u(3)
    pps.sign_data_hiding_enabled_flag = br.flag()
    pps.cabac_init_present_flag = br.flag()
    pps.num_ref_idx_l0_default_active_minus1 = br.ue()
    pps.num_ref_idx_l1_default_active_minus1 = br.ue()
    pps.init_qp_minus26 = br.se()
    pps.constrained_intra_pred_flag = br.flag()
    pps.transform_skip_enabled_flag = br.flag()
    pps.cu_qp_delta_enabled_flag = br.flag()
    if pps.cu_qp_delta_enabled_flag:
        pps.diff_cu_qp_delta_depth = br.ue()
    pps.pps_cb_qp_offset = br.se()
    pps.pps_cr_qp_offset = br.se()
    pps.pps_slice_chroma_qp_offsets_present_flag = br.flag()
    pps.weighted_pred_flag = br.flag()
    pps.weighted_bipred_flag = br.flag()
    pps.transquant_bypass_enabled_flag = br.flag()
    pps.tiles_enabled_flag = br.flag()
    pps.entropy_coding_sync_enabled_flag = br.flag()
    if pps.tiles_enabled_flag:
        pps.num_tile_columns_minus1 = br.ue()
        pps.num_tile_rows_minus1 = br.ue()
        assert br.flag() == 1, "only uniform tile spacing supported"
        br.flag()        # loop_filter_across_tiles_enabled_flag
    pps.pps_loop_filter_across_slices_enabled_flag = br.flag()
    pps.deblocking_filter_control_present_flag = br.flag()
    if pps.deblocking_filter_control_present_flag:
        pps.deblocking_filter_override_enabled_flag = br.flag()
        pps.pps_deblocking_filter_disabled_flag = br.flag()
        if not pps.pps_deblocking_filter_disabled_flag:
            pps.pps_beta_offset_div2 = br.se()
            pps.pps_tc_offset_div2 = br.se()
    pps.pps_scaling_list_data_present_flag = br.flag()
    if pps.pps_scaling_list_data_present_flag:
        pps.scaling_list_data = _parse_scaling_list_data(br)
    pps.lists_modification_present_flag = br.flag()
    pps.log2_parallel_merge_level_minus2 = br.ue()
    pps.slice_segment_header_extension_present_flag = br.flag()
    # pps_extension (spec 7.3.3.3.1 pps_range_extension)
    if br.flag():                       # pps_extension_present_flag
        range_ext = br.flag()
        br.flag(); br.flag(); br.flag()  # multilayer / 3d / scc
        br.u(4)
        if range_ext:
            if pps.transform_skip_enabled_flag:
                pps.log2_max_transform_skip_block_size_minus2 = br.ue()
            pps.cross_component_prediction_enabled_flag = br.flag()
            pps.chroma_qp_offset_list_enabled_flag = br.flag()
            if pps.chroma_qp_offset_list_enabled_flag:
                pps.diff_cu_chroma_qp_offset_depth = br.ue()
                n = br.ue() + 1
                pps.cb_qp_offset_list = []
                pps.cr_qp_offset_list = []
                for _ in range(n):
                    pps.cb_qp_offset_list.append(br.se())
                    pps.cr_qp_offset_list.append(br.se())
            pps.log2_sao_offset_scale_luma = br.ue()
            pps.log2_sao_offset_scale_chroma = br.ue()
    return pps


def _parse_wp_table(br: BitReader, sh: SliceHeader, sps: SPS) -> None:
    """pred_weight_table (spec 7.3.6.3; reference TDecCAVLC
    parsePredWeightTable:1340). Stores per-list per-ref weights:
    sh.wp_tables[list][ref] = (luma (w, o) or None,
                               chroma [(w, o), (w, o)] or None)."""
    sh.wp_log2_denom = br.ue()
    chroma = sps.chroma_format_idc != 0
    cdenom = sh.wp_log2_denom
    if chroma:
        cdenom = sh.wp_log2_denom + br.se()
    sh.wp_chroma_log2_denom = cdenom
    nlists = 2 if sh.slice_type == SliceType.B else 1
    sh.wp_tables = [[], []]
    for lx in range(nlists):
        nref = sh.num_ref_idx_active[lx]
        lflags = [br.flag() for _ in range(nref)]
        cflags = ([br.flag() for _ in range(nref)] if chroma
                  else [0] * nref)
        for i in range(nref):
            lw = None
            if lflags[i]:
                w = (1 << sh.wp_log2_denom) + br.se()
                o = br.se()
                lw = (w, o)
            cw = None
            if cflags[i]:
                cw = []
                for _ in range(2):
                    w = (1 << cdenom) + br.se()
                    delta_off = br.se()
                    # spec 7.4.7.3 ChromaOffset derivation
                    shift = 1 << 7   # 8-bit weighted pred offset range
                    o = max(-128, min(127,
                                      delta_off + shift
                                      - ((shift * w) >> cdenom)))
                    cw.append((w, o))
            sh.wp_tables[lx].append((lw, cw))
    # legacy single-weight fields (list 0, ref 0 luma)
    if sh.wp_tables[0] and sh.wp_tables[0][0][0] is not None:
        sh.wp_luma_flag = 1
        sh.wp_weight, sh.wp_offset = sh.wp_tables[0][0][0]


def parse_slice_header(rbsp: bytes, nal_type: int, sps: SPS, pps: PPS,
                       prev_tid0_poc: int = 0) -> tuple:
    """Returns (SliceHeader, offset_bytes) where offset is the start of the
    CABAC slice data within the RBSP. prev_tid0_poc drives the POC-msb
    derivation (spec 8.3.1; reference TDecCAVLC parseSliceHeader:1011)."""
    br = BitReader(rbsp)
    sh = SliceHeader(nal_unit_type=nal_type)
    sh.first_slice_segment_in_pic_flag = br.flag()
    if 16 <= nal_type <= 23:
        sh.no_output_of_prior_pics_flag = br.flag()
    sh.slice_pic_parameter_set_id = br.ue()
    sh.dependent_slice_segment_flag = 0
    sh.slice_segment_address = 0
    if not sh.first_slice_segment_in_pic_flag:
        if pps.dependent_slice_segments_enabled_flag:
            sh.dependent_slice_segment_flag = br.flag()
        ctus = (-(-sps.pic_width_in_luma_samples // sps.ctu_size)
                * -(-sps.pic_height_in_luma_samples // sps.ctu_size))
        nbits = max(1, (ctus - 1).bit_length())
        sh.slice_segment_address = br.u(nbits)
    if sh.dependent_slice_segment_flag:
        # dependent segment short header (spec 7.3.6.1): every slice
        # parameter is inherited from the preceding independent segment
        # — only entry points / extension / alignment remain
        if pps.tiles_enabled_flag or pps.entropy_coding_sync_enabled_flag:
            n_entry = br.ue()
            if n_entry:
                olen = br.ue() + 1
                sh.entry_point_offsets = [br.u(olen) + 1
                                          for _ in range(n_entry)]
        if pps.slice_segment_header_extension_present_flag:
            ext_len = br.ue()
            for _ in range(ext_len):
                br.u(8)
        br.u(1)  # alignment bit one
        br.byte_align()
        return sh, br.byte_pos
    for _ in range(pps.num_extra_slice_header_bits):
        br.flag()
    sh.slice_type = SliceType(br.ue())
    if pps.output_flag_present_flag:
        br.flag()
    is_idr = nal_type in (19, 20)
    sh.lt_pocs = []       # long-term reference POCs (resolved or lsb-only)
    sh.lt_used = []
    sh.lt_has_msb = []
    if not is_idr:
        nbits = sps.log2_max_pic_order_cnt_lsb_minus4 + 4
        poc_lsb = br.u(nbits)
        max_lsb = 1 << nbits
        prev_lsb = prev_tid0_poc & (max_lsb - 1)
        prev_msb = prev_tid0_poc - prev_lsb
        if poc_lsb < prev_lsb and prev_lsb - poc_lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif poc_lsb > prev_lsb and poc_lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        if nal_type in (16, 17, 18):   # BLA: POCmsb = 0
            msb = 0
        sh.poc = msb + poc_lsb
        if br.flag():  # short_term_ref_pic_set_sps_flag
            sh.short_term_ref_pic_set_sps_flag = 1
            n = len(sps.short_term_rps)
            if n > 1:
                import math
                sh.rps_sps_idx = br.u(max(1, math.ceil(math.log2(n))))
            sh.rps = sps.short_term_rps[sh.rps_sps_idx]
        else:
            sh.rps = parse_st_rps(br, len(sps.short_term_rps),
                                  sps.short_term_rps,
                                  in_slice_header=True)
        if sps.long_term_ref_pics_present_flag:
            # spec 7.3.6.1 long-term part; reference TDecCAVLC:1066-1146
            n_sps_cand = len(getattr(sps, "_lt_poc_lsb_sps", []))
            num_lt_sps = br.ue() if n_sps_cand > 0 else 0
            bits_lt = max(0, (max(n_sps_cand - 1, 0)).bit_length()) \
                if n_sps_cand > 1 else 0
            num_lt_pics = br.ue()
            prev_delta_msb = 0
            delta_msb_cycle = 0
            total = num_lt_sps + num_lt_pics
            for k in range(total):
                if k < num_lt_sps:
                    idx = br.u(bits_lt) if bits_lt > 0 else 0
                    poc_lsb_lt = sps._lt_poc_lsb_sps[idx]
                    used = sps._lt_used_sps[idx]
                else:
                    poc_lsb_lt = br.u(nbits)
                    used = br.flag()
                msb_present = br.flag()
                if msb_present:
                    cyc = br.ue()
                    if k == 0 or k == num_lt_sps:
                        delta_msb_cycle = cyc
                    else:
                        delta_msb_cycle = cyc + prev_delta_msb
                    poc_lt = (sh.poc - delta_msb_cycle * max_lsb
                              - poc_lsb + poc_lsb_lt)
                    sh.lt_pocs.append(poc_lt)
                    sh.lt_has_msb.append(True)
                else:
                    if k == num_lt_sps:
                        delta_msb_cycle = 0
                    sh.lt_pocs.append(poc_lsb_lt)
                    sh.lt_has_msb.append(False)
                sh.lt_used.append(used)
                prev_delta_msb = delta_msb_cycle
        if sps.sps_temporal_mvp_enabled_flag:
            sh.slice_temporal_mvp_enabled_flag = br.flag()
    else:
        sh.poc = 0
    if sps.sample_adaptive_offset_enabled_flag:
        sh.slice_sao_luma_flag = br.flag()
        if sps.chroma_format_idc != 0:
            sh.slice_sao_chroma_flag = br.flag()
    sh.list_entries = [None, None]
    if sh.slice_type != SliceType.I:
        override = br.flag()
        n0 = pps.num_ref_idx_l0_default_active_minus1 + 1
        n1 = pps.num_ref_idx_l1_default_active_minus1 + 1
        if override:
            n0 = br.ue() + 1
            if sh.slice_type == SliceType.B:
                n1 = br.ue() + 1
        sh.num_ref_idx_active = [n0, n1 if sh.slice_type == SliceType.B else 0]
        # NumPicTotalCurr (spec 7.4.7.2): used st + used lt pictures
        n_curr = (sum(sh.rps.used_flags) if sh.rps else 0) \
            + sum(sh.lt_used)
        if pps.lists_modification_present_flag and n_curr > 1:
            # ref_pic_list_modification (spec 7.3.6.2; reference
            # TDecCAVLC.cpp:1216)
            ebits = max(1, (n_curr - 1).bit_length())
            if br.flag():
                sh.list_entries[0] = [br.u(ebits) for _ in range(n0)]
            if sh.slice_type == SliceType.B and br.flag():
                sh.list_entries[1] = [br.u(ebits) for _ in range(n1)]
        if sh.slice_type == SliceType.B:
            sh.mvd_l1_zero_flag = br.flag()
        if pps.cabac_init_present_flag:
            sh.cabac_init_flag = br.flag()
        if sh.slice_temporal_mvp_enabled_flag:
            if sh.slice_type == SliceType.B:
                sh.collocated_from_l0_flag = br.flag()
            lidx = 0 if sh.collocated_from_l0_flag else 1
            if sh.num_ref_idx_active[lidx] > 1:
                sh.collocated_ref_idx = br.ue()
        if ((pps.weighted_pred_flag and sh.slice_type == SliceType.P)
                or (pps.weighted_bipred_flag
                    and sh.slice_type == SliceType.B)):
            _parse_wp_table(br, sh, sps)
        sh.five_minus_max_num_merge_cand = br.ue()
    sh.slice_qp = 26 + pps.init_qp_minus26 + br.se()
    if pps.pps_slice_chroma_qp_offsets_present_flag:
        sh.slice_cb_qp_offset = br.se()
        sh.slice_cr_qp_offset = br.se()
    deblock_disabled = pps.pps_deblocking_filter_disabled_flag
    beta_off = pps.pps_beta_offset_div2
    tc_off = pps.pps_tc_offset_div2
    if pps.deblocking_filter_control_present_flag:
        override_db = 0
        if pps.deblocking_filter_override_enabled_flag:
            override_db = br.flag()
        if override_db:
            deblock_disabled = br.flag()
            if not deblock_disabled:
                beta_off = br.se()
                tc_off = br.se()
    sh.slice_deblocking_filter_disabled_flag = deblock_disabled
    sh.slice_beta_offset_div2 = beta_off
    sh.slice_tc_offset_div2 = tc_off
    if (pps.pps_loop_filter_across_slices_enabled_flag
            and (sh.slice_sao_luma_flag or sh.slice_sao_chroma_flag
                 or not deblock_disabled)):
        sh.slice_loop_filter_across_slices_enabled_flag = br.flag()
    if pps.tiles_enabled_flag or pps.entropy_coding_sync_enabled_flag:
        n_entry = br.ue()
        if n_entry:
            olen = br.ue() + 1
            sh.entry_point_offsets = [br.u(olen) + 1
                                      for _ in range(n_entry)]
    if pps.slice_segment_header_extension_present_flag:
        ext_len = br.ue()
        for _ in range(ext_len):
            br.u(8)
    br.u(1)  # alignment bit one
    br.byte_align()
    return sh, br.byte_pos
