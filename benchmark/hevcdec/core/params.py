"""Parameter set and slice-level state dataclasses.

Parity: reference TComSlice.h (TComVPS:431, TComSPS:720, TComPPS:981,
TComSlice:1202) — reduced to the fields this framework actually encodes.
Field names follow the HEVC spec syntax element names so the header writers
(hevc_tpu_torch/entropy/headers.py) read as a transliteration of spec 7.3.2.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from .types import ChromaFormat, SliceType


class ScalingListData:
    """Explicit scaling matrices (spec 7.3.4 scaling_list_data;
    reference TComScalingList, TComSlice.cpp:2066 xParseScalingList).

    lists[sizeId][listId]: flat raster coefficient list — 16 entries for
    sizeId 0 (4x4), 64 for sizeId 1..3 (the 16x16/32x32 matrices store
    the 8x8 sub-sampled form upsampled at use). dc[sizeId][listId] holds
    the explicit DC for sizeId >= 2. listId = cIdx + (intra ? 0 : 3);
    the 32x32 chroma entries are derived from 16x16 as HM does."""

    N_SIZES = 4
    N_LISTS = 6

    def __init__(self):
        import numpy as np
        self.lists = [[None] * self.N_LISTS for _ in range(self.N_SIZES)]
        self.dc = [[16] * self.N_LISTS for _ in range(self.N_SIZES)]

    def set_default(self, size_id: int, list_id: int) -> None:
        from . import tables
        import numpy as np
        if size_id == 0:
            m = np.full((4, 4), 16, np.int32)
        else:
            m = (tables.QUANT_INTRA_DEF8 if list_id < 3
                 else tables.QUANT_INTER_DEF8)
        self.lists[size_id][list_id] = m.reshape(-1).copy()
        self.dc[size_id][list_id] = 16

    _MATRIX_NAMES = [
        ["INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV",
         "INTER4X4_LUMA", "INTER4X4_CHROMAU", "INTER4X4_CHROMAV"],
        ["INTRA8X8_LUMA", "INTRA8X8_CHROMAU", "INTRA8X8_CHROMAV",
         "INTER8X8_LUMA", "INTER8X8_CHROMAU", "INTER8X8_CHROMAV"],
        ["INTRA16X16_LUMA", "INTRA16X16_CHROMAU", "INTRA16X16_CHROMAV",
         "INTER16X16_LUMA", "INTER16X16_CHROMAU", "INTER16X16_CHROMAV"],
        ["INTRA32X32_LUMA", None, None, "INTER32X32_LUMA", None, None],
    ]

    @classmethod
    def from_hm_file(cls, path: str) -> "ScalingListData":
        """Parse the reference encoder's scaling-list text format
        (reference TComScalingList::xParseScalingList,
        TComSlice.cpp:2066): a '<NAME> =' header line followed by
        comma-separated coefficients in raster order, with a separate
        '<NAME>_DC =' value for the 16x16/32x32 matrices. The 32x32
        chroma entries are derived from 16x16, as HM does."""
        import re
        import numpy as np
        text = open(path).read()
        lines = text.split("\n")

        def ints_after(token, count, exclude=None):
            for li, line in enumerate(lines):
                if token in line and (exclude is None or exclude not in line):
                    rest = "\n".join(lines[li + 1:])
                    vals = re.findall(r"-?\d+", rest)[:count]
                    if len(vals) < count:
                        raise ValueError(
                            f"scaling list file: matrix {token} truncated")
                    return [int(v) for v in vals]
            raise ValueError(f"scaling list file: matrix {token} not found")

        sld = cls()
        for size_id in range(4):
            for list_id in range(6):
                name = cls._MATRIX_NAMES[size_id][list_id]
                if name is None:      # chroma 32x32: derive from 16x16
                    sld.lists[3][list_id] = sld.lists[2][list_id].copy()
                    sld.dc[3][list_id] = sld.dc[2][list_id]
                    continue
                n = 4 if size_id == 0 else 8
                vals = ints_after(name, n * n, exclude=name + "_DC")
                sld.lists[size_id][list_id] = np.array(vals, np.int32)
                if size_id >= 2:
                    sld.dc[size_id][list_id] = ints_after(name + "_DC", 1)[0]
                else:
                    sld.dc[size_id][list_id] = vals[0]
        return sld

    def matrix(self, size: int, c_idx: int, intra: bool):
        """Final n x n dequant matrix for a TB (upsampled, DC applied)."""
        import numpy as np
        size_id = {4: 0, 8: 1, 16: 2, 32: 3}[size]
        list_id = (0 if intra else 3) + c_idx
        flat = self.lists[size_id][list_id]
        if flat is None:
            return None
        n = 4 if size_id == 0 else 8
        m = np.asarray(flat, np.int32).reshape(n, n)
        if size > n:
            r = size // n
            m = np.repeat(np.repeat(m, r, 0), r, 1)
            m = m.copy()
            m[0, 0] = self.dc[size_id][list_id]
        return m


@dataclasses.dataclass
class ProfileTierLevel:
    general_profile_idc: int = 1          # Main
    general_level_idc: int = 120          # level 4.0 (30 * 4)
    general_tier_flag: int = 0
    general_progressive_source_flag: int = 1
    general_interlaced_source_flag: int = 0
    general_non_packed_constraint_flag: int = 0
    general_frame_only_constraint_flag: int = 1
    # RExt (profile_idc 4/5) constraint flags, spec 7.3.3
    general_max_12bit_constraint_flag: int = 1
    general_max_10bit_constraint_flag: int = 1
    general_max_8bit_constraint_flag: int = 0
    general_max_422chroma_constraint_flag: int = 0
    general_max_420chroma_constraint_flag: int = 0
    general_max_monochrome_constraint_flag: int = 0
    general_intra_constraint_flag: int = 0
    general_one_picture_only_constraint_flag: int = 0
    general_lower_bit_rate_constraint_flag: int = 1


@dataclasses.dataclass
class VPS:
    vps_video_parameter_set_id: int = 0
    vps_max_layers_minus1: int = 0
    vps_max_sub_layers_minus1: int = 0
    vps_temporal_id_nesting_flag: int = 1
    ptl: ProfileTierLevel = dataclasses.field(default_factory=ProfileTierLevel)
    vps_max_dec_pic_buffering_minus1: int = 4
    vps_max_num_reorder_pics: int = 0
    vps_max_latency_increase_plus1: int = 0


@dataclasses.dataclass
class ShortTermRPS:
    """One short-term reference picture set (spec 7.3.7)."""
    delta_pocs: List[int] = dataclasses.field(default_factory=list)  # negative first
    used_flags: List[int] = dataclasses.field(default_factory=list)

    @property
    def num_negative(self) -> int:
        return sum(1 for d in self.delta_pocs if d < 0)

    @property
    def num_positive(self) -> int:
        return sum(1 for d in self.delta_pocs if d > 0)


def crop_conformance_window(planes, sps):
    """Crop decoded/reconstructed planes to the SPS conformance window
    (spec 7.4.3.2.1 + Table 6-1 SubWidthC/SubHeightC; reference
    TVideoIOYuv::write confLeft..confBottom). Returns views (no copy);
    a no-op when no window is signalled."""
    if not getattr(sps, "conformance_window_flag", 0):
        return planes
    ux = 2 if sps.chroma_format_idc in (1, 2) else 1
    uy = 2 if sps.chroma_format_idc == 1 else 1
    lx = sps.conf_win_left_offset * ux
    rx = sps.conf_win_right_offset * ux
    ty = sps.conf_win_top_offset * uy
    by = sps.conf_win_bottom_offset * uy
    out = []
    for i, p in enumerate(planes):
        sx = sps.chroma_shift_x if i else 0
        sy = sps.chroma_shift_y if i else 0
        h, w = p.shape
        out.append(p[ty >> sy: h - (by >> sy), lx >> sx: w - (rx >> sx)])
    return out


@dataclasses.dataclass
class VuiExt:
    """The optional VUI field groups (annex E.2.1) beyond the flat
    timing/field-sequence subset on SPS (parity: reference TComVUI /
    TEncCavlc::codeVUI and TAppEncCfg's VUI option block)."""
    aspect_ratio_info_present_flag: int = 0
    aspect_ratio_idc: int = 0
    sar_width: int = 0
    sar_height: int = 0
    overscan_info_present_flag: int = 0
    overscan_appropriate_flag: int = 0
    video_signal_type_present_flag: int = 0
    video_format: int = 5
    video_full_range_flag: int = 0
    colour_description_present_flag: int = 0
    colour_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coeffs: int = 2
    chroma_loc_info_present_flag: int = 0
    chroma_sample_loc_type_top_field: int = 0
    chroma_sample_loc_type_bottom_field: int = 0
    neutral_chroma_indication_flag: int = 0
    default_display_window_flag: int = 0
    def_disp_win_left_offset: int = 0
    def_disp_win_right_offset: int = 0
    def_disp_win_top_offset: int = 0
    def_disp_win_bottom_offset: int = 0
    poc_proportional_to_timing_flag: int = 0
    num_ticks_poc_diff_one_minus1: int = 0
    bitstream_restriction_flag: int = 0
    tiles_fixed_structure_flag: int = 0
    motion_vectors_over_pic_boundaries_flag: int = 1
    restricted_ref_pic_lists_flag: int = 0
    min_spatial_segmentation_idc: int = 0
    max_bytes_per_pic_denom: int = 2
    max_bits_per_min_cu_denom: int = 1
    log2_max_mv_length_horizontal: int = 15
    log2_max_mv_length_vertical: int = 15


@dataclasses.dataclass
class SPS:
    sps_video_parameter_set_id: int = 0
    sps_max_sub_layers_minus1: int = 0
    sps_temporal_id_nesting_flag: int = 1
    ptl: ProfileTierLevel = dataclasses.field(default_factory=ProfileTierLevel)
    sps_seq_parameter_set_id: int = 0
    chroma_format_idc: int = int(ChromaFormat.C420)
    pic_width_in_luma_samples: int = 0
    pic_height_in_luma_samples: int = 0
    conformance_window_flag: int = 0
    conf_win_left_offset: int = 0
    conf_win_right_offset: int = 0
    conf_win_top_offset: int = 0
    conf_win_bottom_offset: int = 0
    bit_depth_luma_minus8: int = 0
    bit_depth_chroma_minus8: int = 0
    log2_max_pic_order_cnt_lsb_minus4: int = 4
    sps_max_dec_pic_buffering_minus1: int = 4
    sps_max_num_reorder_pics: int = 0
    sps_max_latency_increase_plus1: int = 0
    log2_min_luma_coding_block_size_minus3: int = 0   # min CU 8
    log2_diff_max_min_luma_coding_block_size: int = 3  # CTU 64
    log2_min_luma_transform_block_size_minus2: int = 0  # min TU 4
    log2_diff_max_min_luma_transform_block_size: int = 3  # max TU 32
    max_transform_hierarchy_depth_inter: int = 3
    max_transform_hierarchy_depth_intra: int = 3
    scaling_list_enabled_flag: int = 0
    scaling_list_data: Optional[ScalingListData] = None
    amp_enabled_flag: int = 0
    sample_adaptive_offset_enabled_flag: int = 0
    pcm_enabled_flag: int = 0
    pcm_sample_bit_depth_luma_minus1: int = 7
    pcm_sample_bit_depth_chroma_minus1: int = 7
    log2_min_pcm_luma_coding_block_size_minus3: int = 0
    log2_diff_max_min_pcm_luma_coding_block_size: int = 2
    pcm_loop_filter_disabled_flag: int = 0
    hrd: object = None   # HrdParameters when HRD signalling is on
    short_term_rps: List[ShortTermRPS] = dataclasses.field(default_factory=list)
    long_term_ref_pics_present_flag: int = 0
    sps_temporal_mvp_enabled_flag: int = 0
    strong_intra_smoothing_enabled_flag: int = 1
    vui_parameters_present_flag: int = 0
    # VUI (annex E.2.1); the always-used subset stays flat, the rest in
    # vui_ext (a VuiExt, or None for an all-defaults VUI)
    vui_field_seq_flag: int = 0
    vui_frame_field_info_present_flag: int = 0
    vui_timing_info_present_flag: int = 0
    vui_num_units_in_tick: int = 1
    vui_time_scale: int = 30
    vui_ext: object = None

    # Derived geometry helpers -------------------------------------------------
    @property
    def bit_depth_luma(self) -> int:
        return 8 + self.bit_depth_luma_minus8

    @property
    def bit_depth_chroma(self) -> int:
        return 8 + self.bit_depth_chroma_minus8

    @property
    def ctu_size(self) -> int:
        return 1 << (self.log2_min_luma_coding_block_size_minus3 + 3
                     + self.log2_diff_max_min_luma_coding_block_size)

    @property
    def min_cu_size(self) -> int:
        return 1 << (self.log2_min_luma_coding_block_size_minus3 + 3)

    @property
    def chroma_shift_x(self) -> int:
        """SubWidthC as a shift (spec Table 6-1)."""
        return 0 if self.chroma_format_idc == 3 else 1

    @property
    def chroma_shift_y(self) -> int:
        """SubHeightC as a shift (spec Table 6-1; 4:2:2 subsamples
        horizontally only)."""
        return 1 if self.chroma_format_idc == 1 else 0

    # sps_range_extension (spec 7.3.2.2.2; all default off)
    transform_skip_rotation_enabled_flag: int = 0
    transform_skip_context_enabled_flag: int = 0
    implicit_rdpcm_enabled_flag: int = 0
    explicit_rdpcm_enabled_flag: int = 0
    extended_precision_processing_flag: int = 0
    intra_smoothing_disabled_flag: int = 0
    high_precision_offsets_enabled_flag: int = 0
    persistent_rice_adaptation_enabled_flag: int = 0
    cabac_bypass_alignment_enabled_flag: int = 0

    @property
    def pic_width_in_ctus(self) -> int:
        return -(-self.pic_width_in_luma_samples // self.ctu_size)

    @property
    def pic_height_in_ctus(self) -> int:
        return -(-self.pic_height_in_luma_samples // self.ctu_size)

    @property
    def num_ctus(self) -> int:
        return self.pic_width_in_ctus * self.pic_height_in_ctus


@dataclasses.dataclass
class PPS:
    pps_pic_parameter_set_id: int = 0
    pps_seq_parameter_set_id: int = 0
    dependent_slice_segments_enabled_flag: int = 0
    output_flag_present_flag: int = 0
    num_extra_slice_header_bits: int = 0
    sign_data_hiding_enabled_flag: int = 0
    cabac_init_present_flag: int = 0
    num_ref_idx_l0_default_active_minus1: int = 0
    num_ref_idx_l1_default_active_minus1: int = 0
    init_qp_minus26: int = 0
    constrained_intra_pred_flag: int = 0
    transform_skip_enabled_flag: int = 0
    cu_qp_delta_enabled_flag: int = 0
    diff_cu_qp_delta_depth: int = 0
    pps_cb_qp_offset: int = 0
    pps_cr_qp_offset: int = 0
    pps_slice_chroma_qp_offsets_present_flag: int = 0
    weighted_pred_flag: int = 0
    weighted_bipred_flag: int = 0
    transquant_bypass_enabled_flag: int = 0
    tiles_enabled_flag: int = 0
    num_tile_columns_minus1: int = 0
    num_tile_rows_minus1: int = 0
    entropy_coding_sync_enabled_flag: int = 0
    pps_loop_filter_across_slices_enabled_flag: int = 1
    deblocking_filter_control_present_flag: int = 0
    deblocking_filter_override_enabled_flag: int = 0
    pps_deblocking_filter_disabled_flag: int = 0
    pps_beta_offset_div2: int = 0
    pps_tc_offset_div2: int = 0
    pps_scaling_list_data_present_flag: int = 0
    scaling_list_data: Optional[ScalingListData] = None
    lists_modification_present_flag: int = 0
    log2_parallel_merge_level_minus2: int = 0
    slice_segment_header_extension_present_flag: int = 0
    # pps_range_extension (spec 7.3.3.3.1; all default off)
    log2_max_transform_skip_block_size_minus2: int = 0
    cross_component_prediction_enabled_flag: int = 0
    chroma_qp_offset_list_enabled_flag: int = 0
    diff_cu_chroma_qp_offset_depth: int = 0
    cb_qp_offset_list: list = dataclasses.field(default_factory=list)
    cr_qp_offset_list: list = dataclasses.field(default_factory=list)
    log2_sao_offset_scale_luma: int = 0
    log2_sao_offset_scale_chroma: int = 0


@dataclasses.dataclass
class HrdParameters:
    """NAL HRD parameters (spec E.2.2, reduced to one sub-layer;
    reference TComHRD, TComSlice.h:283)."""
    bit_rate_scale: int = 2
    cpb_size_scale: int = 3
    initial_cpb_removal_delay_length_minus1: int = 23
    au_cpb_removal_delay_length_minus1: int = 23
    dpb_output_delay_length_minus1: int = 23
    bit_rate_value_minus1: int = 0
    cpb_size_value_minus1: int = 0
    # sub-picture (decoding-unit) level HRD (spec E.2.2/E.2.3; reference
    # TComSPS::setHrdParameters useSubCpbParams branch, TComSlice.cpp:1662)
    sub_pic: int = 0
    tick_divisor_minus2: int = 98
    du_cpb_removal_delay_length_minus1: int = 7
    sub_pic_cpb_params_in_pic_timing_sei_flag: int = 1
    dpb_output_delay_du_length_minus1: int = 12
    cpb_size_du_scale: int = 3
    bit_rate_du_value_minus1: int = 0
    cpb_size_du_value_minus1: int = 0


@dataclasses.dataclass
class SliceHeader:
    """Per-slice state (parity: TComSlice). One slice per picture for now."""
    # WPP: per-substream byte offsets (NAL-payload units incl. emulation
    # prevention), empty when entropy_coding_sync is off
    entry_point_offsets: list = dataclasses.field(default_factory=list)
    # explicit weighted prediction (list 0, single ref): spec 7.4.7.3
    wp_luma_flag: int = 0
    wp_log2_denom: int = 6
    wp_weight: int = 64
    wp_offset: int = 0
    # chroma weights for list 0 ref 0 (reference WeightPredAnalysis
    # derives per-component weights; encoder signals ref 0's)
    wp_chroma_flag: int = 0
    wp_chroma_log2_denom: int = 6
    wp_chroma: tuple = ((64, 0), (64, 0))   # (w, o) for Cb, Cr
    # per-list-0-ref explicit weight sets (pred_weight_table, spec
    # 7.3.6.3): entry r = None (default weighting) or (luma, chroma)
    # with luma = (w, o) or None, chroma = ((wcb, ocb), (wcr, ocr)) or
    # None. Empty tuple -> legacy single-set fields above drive ref 0.
    wp_l0: tuple = ()
    # list-1 explicit weight sets (B slices, PPS weighted_bipred_flag)
    wp_l1: tuple = ()
    slice_type: SliceType = SliceType.I
    nal_unit_type: int = 19  # IDR_W_RADL
    poc: int = 0
    slice_qp: int = 32
    temporal_id: int = 0
    first_slice_segment_in_pic_flag: int = 1
    dependent_slice_segment_flag: int = 0
    slice_segment_address: int = 0
    no_output_of_prior_pics_flag: int = 0
    slice_pic_parameter_set_id: int = 0
    short_term_ref_pic_set_sps_flag: int = 0
    rps: Optional[ShortTermRPS] = None
    rps_sps_idx: int = 0
    num_ref_idx_active: List[int] = dataclasses.field(default_factory=lambda: [0, 0])
    slice_sao_luma_flag: int = 0
    slice_sao_chroma_flag: int = 0
    mvd_l1_zero_flag: int = 0
    cabac_init_flag: int = 0
    collocated_from_l0_flag: int = 1
    collocated_ref_idx: int = 0
    five_minus_max_num_merge_cand: int = 0
    slice_temporal_mvp_enabled_flag: int = 0
    slice_cb_qp_offset: int = 0
    slice_cr_qp_offset: int = 0
    slice_deblocking_filter_disabled_flag: int = 0
    slice_beta_offset_div2: int = 0
    slice_tc_offset_div2: int = 0
    slice_loop_filter_across_slices_enabled_flag: int = 1
    # Reference POC lists, resolved by the GOP scheduler.
    ref_poc_list0: List[int] = dataclasses.field(default_factory=list)
    ref_poc_list1: List[int] = dataclasses.field(default_factory=list)
