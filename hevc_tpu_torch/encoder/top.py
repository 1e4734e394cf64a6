"""Top-level encoder: parameter sets, GOP scheduling, NAL assembly.

Counterpart of hevc_tpu/encoder/top.py with the device hooks in PyTorch:
reference planes are uploaded and edge-padded as torch tensors, the
integer motion search and the intra prescreen run through ops/me_ssd.py
and ops/intra_screen.py, and the one-frame ME lookahead resolves through
runtime.Readback (a CUDA event on a card). The same orchestration runs on
a card and on the CPU.

Parity: reference TEncTop (create/init/encode, TEncTop.cpp:186,325) and
TEncGOP::compressGOP (GOP ordering + POC math TEncGOP.cpp:1045-1075, NAL
and hash-SEI assembly :1593-1692). Supports three GOP shapes:
  - all-intra (IntraPeriod 1)
  - low-delay P/B (contiguous POCs, previous-frame references)
  - random-access hierarchical B from the cfg GOP table (frame
    reordering, per-entry RPS, past+future reference lists)
"""
from __future__ import annotations

import dataclasses
import math
import os
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.params import (PPS, SPS, VPS, ShortTermRPS, SliceHeader,
                            crop_conformance_window)
from ..core.types import NalUnitType, SliceType
from ..entropy import headers, nal, sei
from ..entropy.cabac import SliceDataEncoder, make_slice_params
from .. import runtime
from ..io.cfg import EncoderConfig
from ..utils.timing import timers
from .intra_frame import IntraFrameEncoder
from .inter_frame import PFrameEncoder


def _gop_depth(poc: int, gop_size: int) -> int:
    """Hierarchy depth of a picture from its POC within the GOP, exactly
    as the reference derives it (TEncSlice::initEncSlice depth loop,
    TEncSlice.cpp:206-240): halving steps until the phase matches."""
    if gop_size <= 1:
        return 0
    poc %= gop_size
    if poc == 0:
        return 0
    depth = 0
    step = gop_size
    i = step >> 1
    while i >= 1:
        matched = any(j == poc for j in range(i, gop_size, step))
        step >>= 1
        depth += 1
        if matched:
            break
        i >>= 1
    return depth



def _rf() -> bool:
    """Device fractional-refine tables (HEVC_TPU_ME_REFINE=1,
    ops/me_ssd.refine_tables), default off as in the reference. The engine
    then refines each grid block by one table lookup instead of its 17
    interpolations and SATDs, with the same decisions. With the default
    HEVC_TPU_ME_PREFILTER_REF=1 the lookahead searches, and so refines,
    against the pre-loop-filter luma, which the host loop does not: the
    stream then differs from the one with the tables off."""
    return os.environ.get("HEVC_TPU_ME_REFINE", "0") == "1"

def hm_pic_lambda(qp: float, gop_size: int, gop_poc: int, qp_factor: float,
                  is_intra: bool) -> float:
    """Picture-level RD lambda exactly as the reference computes it
    (TEncSlice::initEncSlice, TEncSlice.cpp:335-371):
      lambda = QPfactor * 2^((QP-12)/3)
    with the I-slice factor scaled by 1 - min(0.5, 0.05*(GOPSize-1)) and
    every non-key picture (hierarchy depth > 0 — hierarchical-B levels
    AND low-delay non-GOP-boundary frames) scaled by Clip3(2, 4,
    (QP-12)/6). HadamardME is on, so the 0.95 no-HAD factor is not
    applied."""
    qp_temp = float(qp) - 12.0
    if is_intra:
        scale = 1.0 - min(0.5, 0.05 * max(0, gop_size - 1))
        lam = 0.57 * scale * (2.0 ** (qp_temp / 3.0))
    else:
        lam = qp_factor * (2.0 ** (qp_temp / 3.0))
    if _gop_depth(gop_poc, gop_size) > 0:
        lam *= min(4.0, max(2.0, qp_temp / 6.0))
    return lam


class EncoderTop:
    def __init__(self, cfg: EncoderConfig, mesh=None,
                 mesh_axis: Optional[str] = None, device=None):
        # the supported-surface contract (io.cfg.validate) holds for every
        # entry point, not just the CLI: library users / bench / parallel
        # get the same xConfirmPara rejects (reference TAppEncCfg.cpp:1691
        # runs for every encode). Tool hints stay silent here.
        from ..io.cfg import validate
        validate(cfg, warn=lambda m: None)
        self.cfg = cfg
        # the device every search and prescreen runs on ("cuda" by
        # default; the tests pass "cpu"). Under a mesh (a parallel.Mesh)
        # it is the mesh's first device, and every motion search splits
        # its block rows over the mesh: the same grids, the same stream,
        # every GOP shape
        if mesh is None:
            self.device = runtime.resolve_device(
                "cuda" if device is None else device)
        else:
            from ..parallel import _same_device
            self.device = mesh.devices[0]
            if device is not None and not _same_device(device, self.device):
                raise ValueError(f"EncoderTop: device {device!r} is not "
                                 f"the mesh's first device {self.device}")
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        # conformance window (reference TAppEncCfg "ConformanceMode" /
        # "ConfWin*" + TVideoIOYuv edge padding; spec 7.4.3.2.1): mode 1
        # pads the coded dimensions up to the min-CU multiple, mode 2
        # pads by the user HorizontalPad/VerticalPad, mode 3 signals the
        # given window. Input frames are edge-replicated to the coded
        # size in encode_frame; decoders crop the window at output.
        self.source_width, self.source_height = cfg.width, cfg.height
        pad_w = pad_h = 0
        cwm = cfg.conformance_window_mode
        if cwm == 1:
            pad_w = (-cfg.width) % 8
            pad_h = (-cfg.height) % 8
        elif cwm == 2:
            pad_w = cfg.horizontal_pad
            pad_h = cfg.vertical_pad
        if pad_w or pad_h:
            cfg = dataclasses.replace(cfg, width=cfg.width + pad_w,
                                      height=cfg.height + pad_h)
        self._conf_pad = (pad_w, pad_h)
        self.cfg = cfg
        self.sps = SPS(
            pic_width_in_luma_samples=cfg.width,
            pic_height_in_luma_samples=cfg.height,
            bit_depth_luma_minus8=cfg.internal_bit_depth - 8,
            bit_depth_chroma_minus8=cfg.internal_bit_depth - 8,
            chroma_format_idc=cfg.internal_chroma_format,
            # the reference writes QuadtreeTUMaxDepth{Intra,Inter} - 1 as
            # the SPS max_transform_hierarchy_depth (TEncCavlc codeSPS)
            max_transform_hierarchy_depth_intra=max(
                0, cfg.tu_depth_intra - 1),
            max_transform_hierarchy_depth_inter=max(
                0, cfg.tu_depth_inter - 1),
            sample_adaptive_offset_enabled_flag=1 if cfg.sao else 0,
            amp_enabled_flag=1 if cfg.amp else 0,
            scaling_list_enabled_flag=1 if cfg.scaling_list else 0,
        )
        if cwm:
            # SPS conformance window (spec 7.4.3.2.1: offsets in chroma
            # units — winUnitX/Y per chroma_format_idc Table 6-1)
            ux = 2 if cfg.internal_chroma_format in (1, 2) else 1
            uy = 2 if cfg.internal_chroma_format == 1 else 1
            if cwm == 3:
                offs = (cfg.conf_win_left, cfg.conf_win_right,
                        cfg.conf_win_top, cfg.conf_win_bottom)
            else:
                offs = (0, pad_w // ux, 0, pad_h // uy)
            if any(offs):
                self.sps.conformance_window_flag = 1
                (self.sps.conf_win_left_offset,
                 self.sps.conf_win_right_offset,
                 self.sps.conf_win_top_offset,
                 self.sps.conf_win_bottom_offset) = offs
        if cfg.scaling_list == 2:
            # explicit (file-read) scaling lists (reference
            # TComScalingList::xParseScalingList, TAppEncCfg
            # ScalingListFile); all-intra only — the Python intra path
            # quantizes with the custom matrices
            from ..core.params import ScalingListData
            self.sps.scaling_list_data = ScalingListData.from_hm_file(
                cfg.scaling_list_file)
        if (cfg.internal_chroma_format != 1 or cfg.internal_bit_depth > 10
                or "rext" in cfg.profile.lower()):
            # format-range extensions (spec A.3.5): Main 4:4:4 family
            ptl = self.sps.ptl
            ptl.general_profile_idc = 4
            ptl.general_max_12bit_constraint_flag = \
                1 if cfg.internal_bit_depth <= 12 else 0
            ptl.general_max_10bit_constraint_flag = \
                1 if cfg.internal_bit_depth <= 10 else 0
            ptl.general_max_8bit_constraint_flag = \
                1 if cfg.internal_bit_depth <= 8 else 0
            ptl.general_max_422chroma_constraint_flag = \
                1 if cfg.internal_chroma_format <= 2 else 0
            ptl.general_max_420chroma_constraint_flag = \
                1 if cfg.internal_chroma_format <= 1 else 0
            ptl.general_intra_constraint_flag = \
                1 if cfg.intra_period == 1 else 0
            ptl.general_lower_bit_rate_constraint_flag = 1
        elif cfg.internal_bit_depth > 8 or cfg.profile == "main10":
            self.sps.ptl.general_profile_idc = 2
        self.vps = VPS()
        self.vps.ptl.general_profile_idc = self.sps.ptl.general_profile_idc
        self.pps = PPS(init_qp_minus26=cfg.qp - 26)
        if cfg.pcm:
            self.sps.pcm_enabled_flag = 1
            self.sps.pcm_sample_bit_depth_luma_minus1 = \
                cfg.internal_bit_depth - 1
            self.sps.pcm_sample_bit_depth_chroma_minus1 = \
                cfg.internal_bit_depth - 1
        if cfg.transform_skip:
            # 4x4 transform-skip trials run only in the native engine path
            self.pps.transform_skip_enabled_flag = 1
        # high-throughput RExt tool set (reference TAppEncCfg
        # ResidualRotation / SingleSignificanceMapContext /
        # GolombRiceParameterAdaptation / AlignCABACBeforeBypass)
        if cfg.residual_rotation and (cfg.transform_skip
                                      or cfg.tq_bypass_force):
            # rotation applies to 4x4 intra TS TBs and (lossless mode)
            # 4x4 intra transquant-bypass TBs (reference TComTU
            # isNonTransformedResidualRotated)
            self.sps.transform_skip_rotation_enabled_flag = 1
        if cfg.implicit_rdpcm and cfg.tq_bypass_force:
            # implicit residual DPCM of the passthrough residual on
            # intra horizontal/vertical lossless TBs (reference
            # TComTrQuant::xT + invRdpcmNxN bypass branch; spec RExt).
            # The encode-side diff lives in IntraFrameEncoder._code_tb;
            # it also disables the intra edge/DC boundary filters for
            # lossless CUs (TComPrediction.cpp:481 enableEdgeFilters)
            self.sps.implicit_rdpcm_enabled_flag = 1
        if (cfg.cross_comp_pred and cfg.internal_chroma_format == 3
                and cfg.intra_period == 1
                and os.environ.get("HEVC_TPU_NATIVE_RECON", "1") != "0"):
            # cross-component prediction (4:4:4, spec 8.6.6): the native
            # intra engine predicts each chroma TB's residual from the
            # TU's reconstructed luma residual with a least-squares
            # alpha (reference TEncSearch::
            # xCalcCrossComponentPredictionAlpha); PPS range extension
            # carries the enable flag
            self.pps.cross_component_prediction_enabled_flag = 1
        if cfg.explicit_rdpcm and (cfg.tq_bypass_force
                                   or cfg.transform_skip):
            # explicit (inter) residual DPCM: on lossless TBs the slice
            # writer signals flag+direction per inter bypass TB from the
            # frame encoder's per-TB decision (min sum-of-levels over
            # {off, horizontal, vertical}); on LOSSY transform-skip TBs
            # the native engine trials quantized sequential DPCM in both
            # directions against plain TS (reference TEncSearch RDPCM
            # trial, TComTrQuant::applyForwardRDPCM, TComTrQuant.cpp:1749)
            self.sps.explicit_rdpcm_enabled_flag = 1
        if cfg.single_sig_ctx and cfg.transform_skip:
            self.sps.transform_skip_context_enabled_flag = 1
        if cfg.rice_adaptation:
            self.sps.persistent_rice_adaptation_enabled_flag = 1
        if cfg.align_cabac_bypass:
            self.sps.cabac_bypass_alignment_enabled_flag = 1
        # LCULevelRateControl only applies under RateControl=1 (reference
        # TAppEncCfg: the cfg files list it under a disabled RateControl
        # section; honouring it unconditionally enabled CTU-QP modulation
        # on every CTC low-delay encode and inflated bitrates)
        lcu_rc = cfg.lcu_rate_control and cfg.rate_control \
            and cfg.target_bitrate
        if ((cfg.adaptive_qp or lcu_rc)
                and cfg.internal_chroma_format == 1
                and os.environ.get("HEVC_TPU_NATIVE_RECON", "1") != "0"):
            # CTU-granularity quantization groups (cu_qp_delta); driven by
            # the variance preanalysis (AdaptiveQP) and/or CTU-level rate
            # control (reference TEncPic/TEncPreanalyzer, TEncRateCtrl)
            # quantization groups of size ctu >> MaxCuDQPDepth
            # (cu_qp_delta); driven by the variance preanalysis
            # (AdaptiveQP) and/or CTU-level rate control (reference
            # TEncPic/TEncPreanalyzer, TEncRateCtrl, TComPPS
            # setMaxCuDQPDepth)
            self.pps.cu_qp_delta_enabled_flag = 1
            self.pps.diff_cu_qp_delta_depth = cfg.max_cu_dqp_depth
        if (cfg.sign_hide
                and (cfg.internal_chroma_format == 1 or
                     (cfg.internal_chroma_format == 3
                      and cfg.intra_period == 1))
                and os.environ.get("HEVC_TPU_NATIVE_RECON", "1") != "0"):
            # the native engine enforces the parity constraint (4:2:0
            # everywhere; 4:4:4 when every picture takes the native
            # intra path), including under explicit scaling matrices
            # (sbh_enforce re-quantizes with the installed table)
            self.pps.sign_data_hiding_enabled_flag = 1
        if cfg.slice_segment_mode in (1, 2, 3):
            # dependent slice segments (reference TAppEncCfg.cpp:852);
            # mode 3 = tile-aligned segments (FIXED_NUMBER_OF_TILES,
            # TEncSlice::xDetermineStartAndBoundingCtuTsAddr)
            self.pps.dependent_slice_segments_enabled_flag = 1
        self.tiles = (max(cfg.tile_cols_minus1, 0),
                      max(cfg.tile_rows_minus1, 0))
        if self.tiles != (0, 0):
            self.pps.tiles_enabled_flag = 1
            self.pps.num_tile_columns_minus1 = self.tiles[0]
            self.pps.num_tile_rows_minus1 = self.tiles[1]
            self.sps._tile_cols = self.tiles[0] + 1
            self.sps._tile_rows = self.tiles[1] + 1
        elif cfg.wpp:
            self.pps.entropy_coding_sync_enabled_flag = 1
        if cfg.tq_bypass_force:
            self.pps.transquant_bypass_enabled_flag = 1
        if getattr(cfg, "constrained_intra_pred", 0):
            # constrained intra prediction (reference TAppEncCfg
            # "ConstrainedIntraPred"; spec 8.4.4.2.2 substitution of
            # inter-coded neighbour samples — honoured in the native
            # engine's reference-sample fetch and both decoders)
            self.pps.constrained_intra_pred_flag = 1
        if getattr(cfg, "log2_parallel_merge_level", 2) > 2:
            # merge estimation regions (reference TAppEncCfg
            # "Log2ParallelMergeLevel"; spec 6.4.2 + singleMCLFlag) —
            # the shared PicMaps derivation applies it on both sides
            self.pps.log2_parallel_merge_level_minus2 = \
                cfg.log2_parallel_merge_level - 2
        if cfg.cb_qp_offset or cfg.cr_qp_offset:
            self.pps.pps_cb_qp_offset = cfg.cb_qp_offset
            self.pps.pps_cr_qp_offset = cfg.cr_qp_offset
        if cfg.weighted_pred_p:
            self.pps.weighted_pred_flag = 1
        if getattr(cfg, "weighted_pred_b", 0):
            self.pps.weighted_bipred_flag = 1
        if (cfg.sei_buffering_period or cfg.sei_pic_timing
                or cfg.sei_decoding_unit_info):
            # HRD (annex E.2.2 / C: reference TEncTop xSetHrdParameters):
            # NAL HRD with one CPB sized for ~1s at the target or a
            # nominal rate; buffering-period SEI at each IRAP and CPB
            # delays in pic_timing
            from ..core.params import HrdParameters
            rate = (cfg.target_bitrate or 1000) * 1000
            hrd = HrdParameters()
            hrd.bit_rate_value_minus1 = max(
                0, rate // (1 << (6 + hrd.bit_rate_scale)) - 1)
            hrd.cpb_size_value_minus1 = max(
                0, rate // (1 << (4 + hrd.cpb_size_scale)) - 1)
            # decoding-unit (sub-picture) CPB operation when the AU is
            # split into slice DUs (reference TEncTop.cpp:686-690:
            # useSubCpbParams = SliceMode > 0 || SliceSegmentMode > 0)
            if ((cfg.sei_pic_timing or cfg.sei_decoding_unit_info)
                    and (cfg.slice_mode > 0
                         or cfg.slice_segment_mode > 0)):
                hrd.sub_pic = 1
                hrd.bit_rate_du_value_minus1 = hrd.bit_rate_value_minus1
                hrd.cpb_size_du_value_minus1 = max(
                    0, rate // (1 << (4 + hrd.cpb_size_du_scale)) - 1)
            self.sps.hrd = hrd
            self.sps.vui_parameters_present_flag = 1
            self.sps.vui_timing_info_present_flag = 1
            self.sps.vui_num_units_in_tick = 1
            self.sps.vui_time_scale = int(round(cfg.frame_rate or 30))
        self._au_count_since_bp = 0
        # FIFO of dispatched-but-unresolved intra prescreens (one entry
        # per not-yet-encoded frame, in display order)
        self._intra_screen_q = deque()
        if cfg.vui or cfg.field_coding:
            # VUI timing info (annex E.2.1; reference TEncTop xInitSPS VUI
            # block). For field coding each coded picture is one field:
            # the tick rate doubles and field_seq/frame_field info are set
            # (reference TEncGOP field path + xWriteSEIPictureTiming).
            self.sps.vui_parameters_present_flag = 1
            self.sps.vui_timing_info_present_flag = 1
            self.sps.vui_num_units_in_tick = 1
            fr = int(round(cfg.frame_rate or 30))
            self.sps.vui_time_scale = fr * (2 if cfg.field_coding else 1)
            if cfg.field_coding:
                self.sps.vui_field_seq_flag = 1
                self.sps.vui_frame_field_info_present_flag = 1
                self.sps.ptl.general_progressive_source_flag = 0
                self.sps.ptl.general_interlaced_source_flag = 1
        if cfg.vui:
            # optional VUI groups (annex E.2.1; reference TAppEncCfg's
            # VUI option block -> TEncTop xInitSPS -> TEncCavlc codeVUI)
            from ..core.params import VuiExt
            v = self.sps.vui_ext = VuiExt()
            v.aspect_ratio_info_present_flag = cfg.vui_aspect_ratio_present
            v.aspect_ratio_idc = cfg.vui_aspect_ratio_idc
            v.sar_width = cfg.vui_sar_width
            v.sar_height = cfg.vui_sar_height
            v.overscan_info_present_flag = cfg.vui_overscan_present
            v.overscan_appropriate_flag = cfg.vui_overscan_appropriate
            v.video_signal_type_present_flag = cfg.vui_video_signal_present
            v.video_format = cfg.vui_video_format
            v.video_full_range_flag = cfg.vui_video_full_range
            v.colour_description_present_flag = cfg.vui_colour_desc_present
            v.colour_primaries = cfg.vui_colour_primaries
            v.transfer_characteristics = cfg.vui_transfer_characteristics
            v.matrix_coeffs = cfg.vui_matrix_coefficients
            v.chroma_loc_info_present_flag = cfg.vui_chroma_loc_present
            v.chroma_sample_loc_type_top_field = cfg.vui_chroma_loc_top
            v.chroma_sample_loc_type_bottom_field = cfg.vui_chroma_loc_bottom
            v.neutral_chroma_indication_flag = cfg.vui_neutral_chroma
            v.default_display_window_flag = cfg.vui_def_disp_window
            v.def_disp_win_left_offset = cfg.vui_def_disp_left
            v.def_disp_win_right_offset = cfg.vui_def_disp_right
            v.def_disp_win_top_offset = cfg.vui_def_disp_top
            v.def_disp_win_bottom_offset = cfg.vui_def_disp_bottom
            v.poc_proportional_to_timing_flag = cfg.vui_poc_proportional
            v.num_ticks_poc_diff_one_minus1 = cfg.vui_num_ticks_poc_diff
            v.bitstream_restriction_flag = cfg.vui_bitstream_restriction
            v.tiles_fixed_structure_flag = cfg.vui_tiles_fixed_structure
            v.motion_vectors_over_pic_boundaries_flag = \
                cfg.vui_mv_over_pic_boundaries
            v.max_bytes_per_pic_denom = cfg.vui_max_bytes_per_pic_denom
            v.max_bits_per_min_cu_denom = cfg.vui_max_bits_per_min_cu_denom
            v.log2_max_mv_length_horizontal = cfg.vui_log2_max_mv_hor
            v.log2_max_mv_length_vertical = cfg.vui_log2_max_mv_ver
            if cfg.vui_frame_field_info:
                self.sps.vui_frame_field_info_present_flag = 1
        if cfg.tmvp:
            self.sps.sps_temporal_mvp_enabled_flag = 1
        self.dpb_motion = {}   # cvs_poc -> per-4x4 motion field (TMVP)
        if cfg.deblock_disable:
            self.pps.deblocking_filter_control_present_flag = 1
            self.pps.pps_deblocking_filter_disabled_flag = 1
        # low-delay RPS: one SPS RPS per GOP entry carrying the entry's
        # full reference set (reference TEncTop::xInitRPS — the cfg rows'
        # deltas, e.g. -1 -5 -9 -13, chain so every picture a future frame
        # needs stays in the decoder DPB); RA entries write inline RPSs.
        # Early frames whose full set does not exist yet fall back to an
        # inline truncated RPS in the slice header.
        if cfg.gop_entries and not (bool(cfg.gop_entries) and
                                    [e.poc for e in cfg.gop_entries] !=
                                    list(range(1,
                                               len(cfg.gop_entries) + 1))):
            self.sps.short_term_rps = [
                ShortTermRPS(delta_pocs=list(e.reference_pics),
                             used_flags=[1] * len(e.reference_pics))
                for e in cfg.gop_entries]
        else:
            self.sps.short_term_rps = [ShortTermRPS(delta_pocs=[-1],
                                                    used_flags=[1])]
        # retain pictures while any future RPS can reference them
        self._max_ref_delta = max(
            (abs(d) for e in (cfg.gop_entries or [])
             for d in e.reference_pics), default=1)
        self.rc = None
        if cfg.rate_control and cfg.target_bitrate:
            from .rate_ctrl import RateController
            self.rc = RateController(
                cfg.target_bitrate, cfg.frame_rate, cfg.width, cfg.height,
                total_frames=cfg.frames_to_encode,
                gop_size=len(cfg.gop_entries) or cfg.gop_size or 4)
        # reordering state
        entries = cfg.gop_entries
        self.reordered = bool(entries) and \
            [e.poc for e in entries] != list(range(1, len(entries) + 1))
        self.gop_size = len(entries) if entries else cfg.gop_size
        if self.reordered:
            # the decoder must hold pictures back for display reordering
            self.sps.sps_max_num_reorder_pics = self.gop_size - 1
            self.sps.sps_max_dec_pic_buffering_minus1 = self.gop_size + 1
            self.vps.vps_max_num_reorder_pics = self.gop_size - 1
            self.vps.vps_max_dec_pic_buffering_minus1 = self.gop_size + 1
        self.in_buf: Dict[int, List[np.ndarray]] = {}
        self.in_count = 0
        self.dpb: Dict[int, List[np.ndarray]] = {}   # cvs-poc -> recon
        self.out_queue: List[Tuple[int, List[np.ndarray]]] = []
        self.next_out = 0
        self.encoded_upto = 0     # highest cvs-poc encoded + 1 (RA)
        self.poc = 0              # frames submitted (display order)
        self.last_idr_poc = 0
        self.stats: List[dict] = []
        self.recon = None
        self.dpb_recon = None     # last encoded recon (low-delay ref)
        # optional hook: callable(display_poc, size, range, lam_fp) ->
        # (gx, gy) int32 grids or None. Used by the multi-device driver to feed
        # mesh-sharded lookahead integer-ME results into the frame encoder
        # (the inline per-frame device search is skipped when it hits).
        self.me_provider = None
        # reference TEncGOP::compressGOP uiColDir: the B-slice collocated
        # list alternates per coded picture, resetting to 1 per GOP batch
        self._col_dir = 1
        self._col_batch = -1
        # device-resident padded reference Y planes, keyed by cvs_poc:
        # a reconstruction serves as an ME reference for up to
        # NumRefIdxActive later frames, so each upload through the host
        # link is paid once (the reference re-ships the search window per
        # CTU, TEncOpenCL.cpp:271)
        self._dev_refs: Dict[int, object] = {}
        # host-side padded reference planes, one entry per DPB picture
        # (NativeFrameEncoder's MC reads PAD-padded planes; padding a
        # 1080p picture costs ~10 ms and each reference used to be
        # re-padded by every frame that lists it)
        self._padded_refs: Dict[int, list] = {}
        # one-frame ME lookahead (prefetch_frame): the NEXT frame's
        # integer search against every already-final reference is
        # dispatched before the CURRENT frame's encode, so the device
        # computes it under this frame's host work; the last reference
        # (the current frame's recon) dispatches as soon as SAO finishes.
        # Keyed by display POC — two entries can be alive at once (the
        # frame about to be consumed and the freshly prefetched one).
        self._me_pending: Dict[int, dict] = {}

    def _dev_ref(self, poc: int, planes):
        ref = self._dev_refs.get(poc)
        if ref is None:
            from ..ops import me_ssd
            from .native_frame import PAD
            dt = me_ssd.me_dtype(self.sps.bit_depth_luma)
            with timers.loop_span("ref_prep"):
                ref = me_ssd.pad_ref_device(
                    runtime.upload(np.asarray(planes[0], dt), self.device),
                    PAD)
            self._dev_refs[poc] = ref
        return ref

    def _padded_ref(self, poc: int, planes) -> list:
        """PAD-padded host copies of a DPB picture's planes, computed
        once per picture (NativeFrameEncoder's MC reads padded planes;
        every frame that references the picture reuses this cache).
        Evicted with the DPB."""
        cached = self._padded_refs.get(poc)
        if cached is None:
            from ..entropy.cabac import pad_plane_native
            from .native_frame import PAD
            pdt = np.int16 if self.sps.bit_depth_luma <= 14 else np.int32
            with timers.loop_span("ref_prep"):
                cached = [pad_plane_native(np.asarray(p, pdt), PAD)
                          for p in planes]
            self._padded_refs[poc] = cached
        return cached

    # ------------------------------------------------------------------
    def warm_device_programs(self) -> None:
        """Build the kernel libraries (on a card) and run every device
        path the sequence will use once, so one-time costs (nvcc, the
        allocator's first blocks, lazy library loads) land here and not
        mid-sequence — the reference compiles its OpenCL kernels at init
        rather than at first use (TEncTop.cpp:1116 xInitOpenCL). Low-delay
        reference lists grow from one picture at the IDR, so the search
        runs once for 1, 2, 4, ... references up to the GOP's count."""
        import os as _osm
        cfg = self.cfg
        if (self.me_provider is not None
                or _osm.environ.get("HEVC_TPU_WARM", "1") == "0"
                or _osm.environ.get("HEVC_TPU_NATIVE_RECON", "1") == "0"):
            return
        if self.device.type == "cuda":
            runtime.build_kernels()
        depth = self.sps.bit_depth_luma
        h, w = cfg.height, cfg.width
        if _osm.environ.get("HEVC_TPU_INTRA_SCREEN", "1") != "0":
            # every sequence codes I slices (at least the IDR), and each
            # I slice runs the device 35-mode prescreen
            from ..ops.intra_screen import screen_frame_async
            pdt = np.int16 if depth <= 14 else np.int32
            mid = np.full((h, w), 1 << (depth - 1), pdt)
            screen_frame_async(mid, depth, 1.0, device=self.device)()
        if cfg.intra_period == 1:
            return
        if (_osm.environ.get("HEVC_TPU_ME_MULTI", "1") == "0"
                or self.sps.chroma_format_idc != 1):
            return
        from ..ops import me_ssd
        from .native_frame import PAD
        size = self.sps.ctu_size >> 1
        want16 = (_osm.environ.get("HEVC_TPU_CU16", "1") != "0"
                  and size > 16)
        r = cfg.search_range
        orig = runtime.upload(np.zeros((h, w), me_ssd.me_dtype(depth)),
                              self.device)
        refp = me_ssd.pad_ref_device(orig, PAD)
        # reference counts this GOP structure will reach: B slices stack
        # both lists' unique pictures
        nmax = 1
        for e in (cfg.gop_entries or []):
            n = max(1, e.num_ref_pics_active or 1)
            nmax = max(nmax, min(8, 2 * n if e.slice_type == "B" else n))
        if not cfg.gop_entries:
            nmax = 4  # default low-delay ladder
        npad = 1
        # the tables only where the encode computes them (not under a mesh)
        rf = self.mesh is None and _rf()
        while True:
            refs = [refp] * npad
            if want16:
                me_ssd.me_grids_multi2(
                    orig, refs, size, 16, r, self.qp_lam_fp, pad=PAD,
                    depth=depth, mesh=self.mesh, refine=rf)
            else:
                me_ssd.me_grids_multi(orig, refs, size, r, self.qp_lam_fp,
                                      pad=PAD, depth=depth, mesh=self.mesh)
            if npad >= nmax:
                break
            npad *= 2

    @property
    def qp_lam_fp(self) -> int:
        """Any representative fixed-point sqrt(lambda) for the warm-up
        searches (lambda is a runtime operand of every kernel)."""
        lam = 0.57 * (2.0 ** ((self.cfg.qp - 12) / 3.0))
        return int(65536.0 * math.sqrt(lam))

    def prefetch_intra_screen(self, planes: List[np.ndarray]) -> None:
        """Dispatch the device intra prescreen for the NEXT frame (all-
        intra sequences). The dispatch is asynchronous; by the time the
        next encode_frame() needs the candidate lists the device has
        computed them under the current frame's host work — hiding the
        device round trip entirely. Safe no-op otherwise."""
        import math as _math
        import os as _osm
        if (self.cfg.intra_period != 1
                or _osm.environ.get("HEVC_TPU_INTRA_SCREEN", "1") == "0"
                or _osm.environ.get("HEVC_TPU_NATIVE_RECON", "1") == "0"):
            return
        from ..ops.intra_screen import screen_frame_async
        lam = 0.57 * (2.0 ** ((self.cfg.qp - 12) / 3.0))
        pdt = np.int16 if self.cfg.internal_bit_depth <= 14 else np.int32
        self._intra_screen_q.append(screen_frame_async(
            np.ascontiguousarray(planes[0], pdt),
            self.cfg.internal_bit_depth, _math.sqrt(lam),
            device=self.device))

    def prefetch_frame(self, planes: List[np.ndarray]) -> None:
        """One-frame lookahead: dispatch the NEXT frame's device work
        (intra prescreen or integer motion search) so it computes under
        the CURRENT frame's host work. Call with frame N+1's planes just
        before encode_frame(frame N). Always safe — a frame whose
        prediction structure cannot be prefetched simply takes the
        synchronous path."""
        # the work is for the next picture in display order
        nxt = (self.in_count if self.reordered else self.poc) + 1
        with timers.loop_span("lookahead", picture=nxt):
            planes = self._pad_to_coded(planes)
            self.prefetch_intra_screen(planes)
            self._prefetch_me(planes)

    def _next_frame_plan(self):
        """Predict the NEXT submitted frame's coding parameters (cvs_poc,
        slice type, QP, λ, reference POCs) from the deterministic
        low-delay GOP structure — the same selection _encode_streaming
        will make once the current frame is coded. Returns None when the
        prediction is not deterministic (reordered GOPs, rate control) or
        the next frame is intra."""
        cfg = self.cfg
        if self.reordered or self.rc is not None:
            return None
        npoc = self.poc + 1
        cur_is_intra = (self.poc == 0 or
                        (cfg.intra_period > 0 and
                         self.poc % max(cfg.intra_period, 1) == 0))
        if cfg.intra_period > 0 and npoc % max(cfg.intra_period, 1) == 0:
            return None
        last_idr = self.poc if cur_is_intra else self.last_idr_poc
        gop_poc = npoc - last_idr
        cur_cvs = 0 if cur_is_intra else self.poc - self.last_idr_poc
        entries = cfg.gop_entries
        is_b = False
        if entries:
            entry = entries[(gop_poc - 1) % len(entries)]
            qp_off, qf = entry.qp_offset, entry.qp_factor
            is_b = entry.slice_type == "B"
        else:
            entry = None
            qp_off = (3, 2, 3, 1)[(gop_poc - 1) % 4]
            qf = (0.4624, 0.4624, 0.4624, 0.578)[(gop_poc - 1) % 4]
        slice_qp = int(np.clip(cfg.qp + qp_off, 0, 51))
        # future DPB = (cleared at a current-frame IDR) + current frame
        future = set() if cur_is_intra else set(self.dpb)
        future.add(cur_cvs)
        if entry is not None and entry.reference_pics:
            avail = [d for d in entry.reference_pics
                     if (gop_poc + d) in future]
            if not avail:
                avail = [-1]
            avail.sort(reverse=True)
            nact = max(1, min(entry.num_ref_pics_active or 1, len(avail)))
            ref_pocs = [gop_poc + d for d in avail[:nact]]
        else:
            ref_pocs = [gop_poc - 1]
        pic_lam = hm_pic_lambda(slice_qp, self.gop_size or 1, gop_poc,
                                qf, False)
        return {"display_poc": npoc, "cvs_poc": gop_poc,
                "cur_cvs": cur_cvs, "is_b": is_b, "qf": qf,
                "slice_qp": slice_qp, "lam": pic_lam,
                "ref_pocs": ref_pocs}

    def _prefetch_me(self, planes: List[np.ndarray]) -> None:
        """Dispatch the next frame's integer ME for every reference that
        is ALREADY final. The current frame's own recon (usually ref 0)
        dispatches later, as soon as its SAO completes inside
        _encode_au — by the time the next frame's CU engine needs the MV
        grids the device has computed them under host work."""
        import os as _osm
        cfg = self.cfg
        if (cfg.intra_period == 1 or self.mesh is not None
                or self.me_provider is not None
                or _osm.environ.get("HEVC_TPU_ME_PREFETCH", "1") == "0"
                or _osm.environ.get("HEVC_TPU_ME_MULTI", "1") == "0"
                or _osm.environ.get("HEVC_TPU_NATIVE_RECON", "1") == "0"
                or self.sps.chroma_format_idc != 1):
            return
        plan = self._next_frame_plan()
        if plan is None:
            return
        from ..ops import me_ssd
        from .native_frame import PAD
        depth = self.sps.bit_depth_luma
        size = self.sps.ctu_size >> 1
        want16 = (_osm.environ.get("HEVC_TPU_CU16", "1") != "0"
                  and size > 16)
        if not want16:
            return  # the sync single-grid path stays as-is
        r = cfg.search_range
        lam_fp = int(65536.0 * math.sqrt(plan["lam"]))
        orig_dev = runtime.upload(
            np.asarray(planes[0], me_ssd.me_dtype(depth)), self.device)
        ready = [p for p in plan["ref_pocs"]
                 if p != plan["cur_cvs"] and p in self.dpb]
        parts = []
        if ready:
            devs = [self._dev_ref(p, self.dpb[p]) for p in ready]
            if any(d is None for d in devs):
                return
            parts.append((ready, me_ssd.me_grids_multi2_async(
                orig_dev, devs, size, 16, r, lam_fp, pad=PAD,
                depth=depth, refine=_rf())))
        self._me_pending[plan["display_poc"]] = {
            "params": (size, r, lam_fp, depth),
            "orig_dev": orig_dev, "ref_pocs": plan["ref_pocs"],
            "parts": parts}

    def _me_pending_early_dispatch(self, cvs_poc: int,
                                   recon_y: np.ndarray) -> None:
        """Dispatch a pending next-frame search whose ONLY missing
        reference is this frame, against the pre-loop-filter luma the
        engine just produced. See the call site in _encode_au for the
        overlap/quality rationale. HEVC_TPU_ME_PREFILTER_REF=0 falls
        back to the post-SAO dispatch (filtered reference, less
        overlap)."""
        if os.environ.get("HEVC_TPU_ME_PREFILTER_REF", "1") == "0":
            return
        if not self._me_pending:
            return
        from ..ops import me_ssd
        from .native_frame import PAD
        ref_dev = None
        for mp in self._me_pending.values():
            if cvs_poc not in mp["ref_pocs"]:
                continue
            covered = {p for pocs, _ in mp["parts"] for p in pocs}
            missing = [p for p in mp["ref_pocs"] if p not in covered]
            if missing != [cvs_poc]:
                continue  # other refs still outstanding: post-SAO path
            if ref_dev is None:
                dt = me_ssd.me_dtype(self.sps.bit_depth_luma)
                ref_dev = me_ssd.pad_ref_device(runtime.upload(
                    np.asarray(recon_y, dt), self.device), PAD)
            size, r, lam_fp, depth = mp["params"]
            mp["parts"].append(([cvs_poc], me_ssd.me_grids_multi2_async(
                mp["orig_dev"], [ref_dev], size, 16, r, lam_fp, pad=PAD,
                depth=depth, refine=_rf())))
            # every reference is now dispatched: resolve on a worker
            # thread so the wait for the device rides under this frame's
            # loop-filter/entropy tail (the CUDA event wait releases the
            # GIL)
            import threading
            parts = mp["parts"]
            box = {}

            def _bg_resolve(parts=parts, box=box):
                out = {}
                for pocs, collect in parts:
                    for poc, grids in zip(pocs, collect()):
                        out[poc] = grids
                box["out"] = out
            th = threading.Thread(target=_bg_resolve, daemon=True)
            th.start()
            mp["resolved"] = (th, box)

    def _me_pending_late_dispatch(self, cvs_poc: int) -> None:
        """Called as soon as the current frame's recon is final (post-SAO)
        and uploaded: dispatch any pending next-frame search that was
        waiting for this reference."""
        from ..ops import me_ssd
        from .native_frame import PAD
        for mp in self._me_pending.values():
            if cvs_poc not in mp["ref_pocs"]:
                continue
            covered = {p for pocs, _ in mp["parts"] for p in pocs}
            missing = [p for p in mp["ref_pocs"]
                       if p not in covered and p in self._dev_refs]
            if not missing:
                continue
            size, r, lam_fp, depth = mp["params"]
            mp["parts"].append((missing, me_ssd.me_grids_multi2_async(
                mp["orig_dev"], [self._dev_refs[p] for p in missing],
                size, 16, r, lam_fp, pad=PAD, depth=depth, refine=_rf())))

    def _me_pending_take(self, display_poc, ref_l0, ref_l1, lam_fp,
                         size, r, depth):
        """Return a zero-arg resolver of {poc: (gx, gy, gx2, gy2)} when a
        prefetched search covers this frame's exact reference lists and
        search parameters; None otherwise. Consumes the pending entry."""
        for stale in [p for p in self._me_pending if p < display_poc]:
            del self._me_pending[stale]
        mp = self._me_pending.pop(display_poc, None)
        if mp is None or mp["params"] != (size, r, lam_fp, depth):
            return None
        need = {p for p, _ in ref_l0} | \
               ({p for p, _ in ref_l1} if ref_l1 else set())
        covered = {p for pocs, _ in mp["parts"] for p in pocs}
        if not need <= covered:
            return None
        parts = mp["parts"]
        if "resolved" in mp:
            th, box = mp["resolved"]

            def resolve():
                th.join()
                return box["out"]
            return resolve

        def resolve():
            out = {}
            for pocs, collect in parts:
                for poc, grids in zip(pocs, collect()):
                    out[poc] = grids
            return out
        return resolve

    def _du_timing(self, leading_nals, slice_nals):
        """Per-decoding-unit NAL counts and CPB removal delays (reference
        TEncGOP::xCreatePictureTimingSEI DU parameters + xUpdateDuData /
        xUpdateTimingSEI): DU i is slice segment i; the delay between
        consecutive DU removals is proportional to the bits still to
        arrive at the target bitrate, measured in sub-picture clock
        ticks (tick divisor per the SPS HRD). Returns
        (du_data [(num_nalus_in_du, delay_minus1)], delays)."""
        cfg = self.cfg
        hrd = self.sps.hrd
        ndu = len(slice_nals)
        factor = hrd.tick_divisor_minus2 + 2
        # leading section: everything before the first slice, plus the
        # pic_timing itself (~15 bytes) and DU 0's info SEI (~5 bytes;
        # same estimate the reference uses, TEncGOP.cpp:684-688)
        lead_bytes = sum(len(x) for x in leading_nals) + 15
        lead_count = len(leading_nals) + 1
        if cfg.sei_decoding_unit_info:
            lead_bytes += 5
            lead_count += 1
        accum_bits, accum_nals = [], []
        b, c = lead_bytes, lead_count
        for i, sn in enumerate(slice_nals):
            b += len(sn)
            c += 1
            if cfg.sei_decoding_unit_info and i > 0:
                b += 5
                c += 1
            if i == ndu - 1 and getattr(cfg, "hash_sei_type", 1):
                b += 20      # trailing hash SEI estimate
                c += 1
            accum_bits.append(b * 8)
            accum_nals.append(c)
        nn = [accum_nals[0]] + [accum_nals[i] - accum_nals[i - 1]
                                for i in range(1, ndu)]
        delays = [0] * ndu
        if ndu > 1:
            rate = (cfg.target_bitrate or 1000) * 1000
            ticks = (self.sps.vui_time_scale //
                     max(1, self.sps.vui_num_units_in_tick))
            max_diff = factor - 1
            raw = [((accum_bits[ndu - 1] - accum_bits[i]) * ticks
                    * factor) // rate for i in range(ndu - 1)]
            tmp = sum(1 for v in raw if v > max_diff)
            prev = accum = 0
            for i in range(ndu - 2, -1, -1):
                v = raw[i]
                flag = 0
                if v > max_diff:
                    if prev >= max_diff - tmp:
                        v = prev + 1
                        flag = 1
                    else:
                        v = max_diff - tmp + 1
                d = v - prev - 1
                if d < 0:
                    d = 0
                elif tmp > 0 and flag:
                    tmp -= 1
                delays[i] = d
                accum += d + 1
                prev = accum
        return list(zip(nn, delays)), delays

    def _idr_scope_seis(self) -> List[bytes]:
        """IRAP-scoped informative SEIs from the cfg surface (reference
        SEIEncoder initSEIToneMappingInfo/FramePacking/... driven by the
        TAppEncCfg.cpp:948-1060 options; emitted once per IDR like HM's
        per-CVS messages)."""
        from ..entropy import sei
        cfg = self.cfg
        out = []
        if cfg.sei_tone_mapping:
            out.append(sei.write_tone_mapping_sei(
                tone_map_id=cfg.sei_tone_map_id,
                cancel=cfg.sei_tone_map_cancel,
                persistence=cfg.sei_tone_map_persistence,
                coded_bit_depth=cfg.sei_tone_map_coded_depth,
                target_bit_depth=cfg.sei_tone_map_target_depth,
                model_id=cfg.sei_tone_map_model,
                min_value=cfg.sei_tone_map_min,
                max_value=cfg.sei_tone_map_max,
                sigmoid_midpoint=cfg.sei_tone_map_sigmoid_mid,
                sigmoid_width=cfg.sei_tone_map_sigmoid_width))
        if cfg.sei_frame_packing:
            out.append(sei.write_frame_packing_sei(
                cfg.sei_frame_packing_type,
                arrangement_id=cfg.sei_frame_packing_id,
                quincunx=cfg.sei_frame_packing_quincunx,
                content_interpretation=cfg.sei_frame_packing_interp))
        if cfg.sei_segrect_frame_packing:
            out.append(sei.write_segmented_rect_frame_packing_sei(
                cancel=cfg.sei_segrect_frame_packing_cancel,
                content_interpretation=cfg.sei_segrect_frame_packing_type,
                persistence=cfg.sei_segrect_frame_packing_persist))
        if cfg.sei_display_orientation:
            out.append(sei.write_display_orientation_sei(
                cfg.sei_display_orientation))
        if cfg.sei_mastering_display:
            pv = [int(v) for v in cfg.sei_mastering_primaries
                  .replace(",", " ").split()]
            prim = [tuple(pv[i:i + 2]) for i in (0, 2, 4)]
            wp = tuple(int(v) for v in
                       cfg.sei_mastering_white_point.replace(",", " ")
                       .split())[:2]
            out.append(sei.write_mastering_display_sei(
                prim, wp, cfg.sei_mastering_max_lum,
                cfg.sei_mastering_min_lum))
        if cfg.sei_knee_function:
            ip = [int(v) for v in cfg.sei_knee_input_points
                  .replace(",", " ").split()]
            op = [int(v) for v in cfg.sei_knee_output_points
                  .replace(",", " ").split()]
            out.append(sei.write_knee_function_sei(
                knee_id=cfg.sei_knee_id, cancel=cfg.sei_knee_cancel,
                persistence=cfg.sei_knee_persistence,
                input_drange=cfg.sei_knee_input_drange,
                input_disp_luminance=cfg.sei_knee_input_lum,
                output_drange=cfg.sei_knee_output_drange,
                output_disp_luminance=cfg.sei_knee_output_lum,
                input_knee_points=ip, output_knee_points=op))
        if cfg.sei_chroma_filter_hint:
            out.append(sei.write_chroma_sampling_filter_hint_sei(
                ver_idc=cfg.sei_chroma_filter_ver,
                hor_idc=cfg.sei_chroma_filter_hor))
        if cfg.sei_tmcts and (cfg.tile_cols_minus1 or cfg.tile_rows_minus1):
            # temporal MCTS (reference TEncGOP.cpp:412, gated on tiles;
            # SEIEncoder initSEITempMotionConstrainedTileSets builds one
            # tile set per tile)
            out.append(sei.write_tmcts_sei(
                (cfg.tile_cols_minus1 + 1) * (cfg.tile_rows_minus1 + 1)))
        if cfg.sei_sop_description and cfg.gop_entries:
            entries = []
            for i, ge in enumerate(self.cfg.gop_entries[:self.gop_size]):
                entries.append((1, getattr(ge, "temporal_id", 0), i,
                                ge.poc - (self.cfg.gop_entries[i - 1].poc
                                          if i else 0)))
            if entries:
                out.append(sei.write_sop_description_sei(0, entries))
        return out

    def _per_picture_seis(self, idr: bool) -> List[bytes]:
        """Per-access-unit informative SEIs: temporal level-0 index,
        region refresh (GDR), time code, no-display (reference
        SEIEncoder xCreatePerPictureSEIMessages)."""
        from ..entropy import sei
        cfg = self.cfg
        out = []
        if cfg.sei_temporal_level0_index:
            if idr:
                self._rap_idx = getattr(self, "_rap_idx", -1) + 1
                self._tl0_idx = 0
            else:
                self._tl0_idx = getattr(self, "_tl0_idx", 0) + 1
            out.append(sei.write_temporal_level0_index_sei(
                getattr(self, "_tl0_idx", 0),
                getattr(self, "_rap_idx", 0)))
        if cfg.sei_gdr_info and idr:
            out.append(sei.write_region_refresh_sei(1))
        if cfg.sei_time_code and cfg.sei_time_code_num_ts > 0:
            out.append(sei.write_time_code_sei(
                [{"ts_flag": 1} for _ in range(cfg.sei_time_code_num_ts)]))
        # SEINoDisplay=N applies to temporal layers >= N (N > 0); this
        # encoder writes every NAL at temporal id 0, so, like HM on a
        # single-layer stream, the message is never emitted.
        return out

    def _pad_to_coded(self, planes):
        """Edge-replicate source-sized planes up to the coded dimensions
        (conformance-window padding; reference TVideoIOYuv::read pad
        path). No-op when the frame is already coded-size."""
        pw, ph = self._conf_pad
        if (not (pw or ph)) or planes[0].shape == (self.cfg.height,
                                                   self.cfg.width):
            return planes
        out = []
        for i, p in enumerate(planes):
            sx = self.sps.chroma_shift_x if i else 0
            sy = self.sps.chroma_shift_y if i else 0
            out.append(np.pad(p, ((0, ph >> sy), (0, pw >> sx)),
                              mode="edge"))
        return out

    def encode_frame(self, planes: List[np.ndarray]) -> bytes:
        """Submit one frame in display order; returns the Annex-B bytes of
        every access unit that became encodable (possibly empty for RA)."""
        planes = self._pad_to_coded(planes)
        if self.sps.chroma_format_idc == 0 and len(planes) == 1:
            # monochrome input: carry constant placeholder chroma planes
            # through the pipeline (coding, hash and output are
            # luma-only; the placeholders keep plane-triple plumbing
            # uniform)
            h2 = self.cfg.height >> self.sps.chroma_shift_y
            w2 = self.cfg.width >> self.sps.chroma_shift_x
            mid = np.full((h2, w2), 1 << (self.sps.bit_depth_chroma - 1),
                          planes[0].dtype)
            planes = [planes[0], mid, mid.copy()]
        if not self.reordered:
            return self._encode_streaming(planes)
        self.in_buf[self.in_count] = planes
        self.in_count += 1
        return self._drain_ra(flush=False)

    def flush(self) -> bytes:
        if not self.reordered:
            return b""
        return self._drain_ra(flush=True)

    def pop_recons(self) -> List[Tuple[int, List[np.ndarray]]]:
        """Finished pictures in display order (monochrome pictures carry
        the luma plane only, like the decoder's output). Pictures are
        cropped to the conformance window (reference TVideoIOYuv::write
        confLeft..confBottom), matching the reference decoder's recon
        output files."""
        out = []
        self.out_queue.sort(key=lambda t: t[0])
        mono = self.sps.chroma_format_idc == 0
        while self.out_queue and self.out_queue[0][0] == self.next_out:
            n, pl = self.out_queue.pop(0)
            pl = crop_conformance_window(pl, self.sps)
            out.append((n, pl[:1] if mono else pl))
            self.next_out += 1
        return out

    # ------------------------------------------------------------------
    def _encode_streaming(self, planes) -> bytes:
        cfg = self.cfg
        is_intra = (self.poc == 0 or
                    (cfg.intra_period > 0 and
                     self.poc % max(cfg.intra_period, 1) == 0))
        if self.rc:
            comp = 0.0
            if is_intra:
                from .rate_ctrl import intra_complexity
                comp = intra_complexity(np.asarray(planes[0]))
            base_qp = self.rc.pic_qp(is_intra, comp)
        else:
            base_qp = cfg.qp
        if is_intra:
            self.last_idr_poc = self.poc
            au = self._encode_au(planes, display_poc=self.poc, cvs_poc=0,
                                 stype=SliceType.I, slice_qp=base_qp,
                                 qf=0.57, rps=None, ref_l0=None, ref_l1=None,
                                 idr=True)
        else:
            gop_poc = self.poc - self.last_idr_poc
            is_b = False
            entry = None
            entry_idx = 0
            if cfg.gop_entries:
                entry_idx = (gop_poc - 1) % len(cfg.gop_entries)
                entry = cfg.gop_entries[entry_idx]
                qp_off, qf = entry.qp_offset, entry.qp_factor
                is_b = entry.slice_type == "B"
            else:
                qp_off = (3, 2, 3, 1)[(gop_poc - 1) % 4]
                qf = (0.4624, 0.4624, 0.4624, 0.578)[(gop_poc - 1) % 4]
            slice_qp = int(np.clip(base_qp + (0 if self.rc else qp_off),
                                   0, 51))
            # multi-reference list from the GOP entry's RPS (reference
            # TEncSearch per-refIdx search over NumRefIdxActive refs)
            if entry is not None and entry.reference_pics:
                want = list(entry.reference_pics)
                avail = [d for d in want if (gop_poc + d) in self.dpb]
                if not avail:
                    avail = [-1]
                # decoder L0 order: POC < cur by descending POC
                avail.sort(reverse=True)
                full = (avail == sorted(want, reverse=True)
                        and len(self.sps.short_term_rps) ==
                        len(cfg.gop_entries))
                rps = ShortTermRPS(delta_pocs=avail,
                                   used_flags=[1] * len(avail))
                nact = max(1, min(entry.num_ref_pics_active or 1,
                                  len(avail)))
                refs = [(gop_poc + d, self.dpb[gop_poc + d])
                        for d in avail[:nact]]
            else:
                full = len(self.sps.short_term_rps) == 1
                rps = ShortTermRPS(delta_pocs=[-1], used_flags=[1])
                refs = [(gop_poc - 1, self.dpb_recon)]
                entry_idx = 0
            au = self._encode_au(
                planes, display_poc=self.poc, cvs_poc=gop_poc,
                stype=SliceType.B if is_b else SliceType.P,
                slice_qp=slice_qp, qf=qf, rps=rps,
                ref_l0=refs,
                ref_l1=[refs[0]] if is_b else None,
                idr=False, use_sps_rps=full, rps_sps_idx=entry_idx)
        self.poc += 1
        return au

    def _drain_ra(self, flush: bool) -> bytes:
        cfg = self.cfg
        out = b""
        entries = cfg.gop_entries
        gs = self.gop_size
        while True:
            if self.encoded_upto == 0 and 0 in self.in_buf:
                base_qp = self.rc.pic_qp(True) if self.rc else cfg.qp
                out += self._encode_au(
                    self.in_buf.pop(0), display_poc=0, cvs_poc=0,
                    stype=SliceType.I, slice_qp=base_qp, qf=0.57, rps=None,
                    ref_l0=None, ref_l1=None, idr=True)
                self.encoded_upto = 1
                continue
            if self.encoded_upto == 0:
                return out
            gop_start = self.encoded_upto - 1
            have_all = all((gop_start + k) in self.in_buf
                           for k in range(1, gs + 1))
            if have_all:
                for e in entries:
                    p = gop_start + e.poc
                    out += self._encode_ra_entry(self.in_buf.pop(p), p, e)
                self.encoded_upto = gop_start + gs + 1
                continue
            if flush and self.in_buf:
                # tail: remaining frames in display order, low-delay P
                for p in sorted(self.in_buf):
                    ref_poc = max(q for q in self.dpb if q < p)
                    e = entries[(p - gop_start - 1) % len(entries)]
                    rps = ShortTermRPS(delta_pocs=[ref_poc - p],
                                       used_flags=[1])
                    slice_qp = int(np.clip(
                        (self.rc.pic_qp(False) if self.rc else cfg.qp)
                        + (0 if self.rc else e.qp_offset), 0, 51))
                    out += self._encode_au(
                        self.in_buf[p], display_poc=p, cvs_poc=p,
                        stype=SliceType.P, slice_qp=slice_qp,
                        qf=e.qp_factor, rps=rps,
                        ref_l0=[(ref_poc, self.dpb[ref_poc])], ref_l1=None,
                        idr=False)
                self.in_buf.clear()
            return out

    def _encode_ra_entry(self, planes, p, e) -> bytes:
        cfg = self.cfg
        deltas = [d for d in e.reference_pics if (p + d) in self.dpb]
        if not deltas:
            deltas = [max(q for q in self.dpb) - p]
        rps = ShortTermRPS(delta_pocs=deltas, used_flags=[1] * len(deltas))
        # default reference list construction (spec 8.3.4): L0 = past
        # pictures by descending POC then future ascending; L1 mirrored.
        # Truncated to the GOP row's NumRefPicsActive (reference
        # TComSlice::setRefPicList + TEncTop xInitRPS active counts).
        negs = sorted([d for d in deltas if d < 0], reverse=True)
        poss = sorted([d for d in deltas if d > 0])
        is_b = e.slice_type == "B"
        nact = max(1, e.num_ref_pics_active or 1)
        l0_order = (negs + poss)[:nact]
        l1_order = (poss + negs)[:nact]
        slice_qp = int(np.clip(
            (self.rc.pic_qp(False) if self.rc else cfg.qp)
            + (0 if self.rc else e.qp_offset), 0, 51))
        return self._encode_au(
            planes, display_poc=p, cvs_poc=p,
            stype=SliceType.B if is_b else SliceType.P,
            slice_qp=slice_qp, qf=e.qp_factor, rps=rps,
            ref_l0=[(p + d, self.dpb[p + d]) for d in l0_order],
            ref_l1=[(p + d, self.dpb[p + d]) for d in l1_order]
            if is_b else None,
            idr=False)

    # ------------------------------------------------------------------
    def _encode_au(self, planes, *, display_poc, **kw) -> bytes:
        """Code one picture into its access unit (_code_au). Its work is
        for display_poc; the loop span frame_setup holds what this takes
        outside every section and every other loop span: slice
        parameters, the engine's objects and planes before the engine
        call, and the picture's bookkeeping after it."""
        timers.picture = display_poc
        with timers.loop_span("frame_setup"):
            return self._code_au(planes, display_poc=display_poc, **kw)

    def _code_au(self, planes, *, display_poc, cvs_poc, stype, slice_qp,
                 qf, rps, ref_l0, ref_l1, idr,
                 use_sps_rps: bool = False, rps_sps_idx: int = 0) -> bytes:
        """ref_l0/ref_l1: active reference lists, each a list of
        (cvs_poc, recon_planes) in final L0/L1 order."""
        cfg = self.cfg
        is_intra = stype == SliceType.I
        is_b = stype == SliceType.B
        if self.pps.weighted_pred_flag or self.pps.weighted_bipred_flag:
            # whole-picture AC/DC of the ORIGINAL (reference
            # xCalcACDCParamSlice stores these on the slice for later
            # pictures' weight fits)
            from .wp_analysis import calc_acdc
            if not hasattr(self, "_wp_acdc"):
                self._wp_acdc = {}
            self._wp_acdc[cvs_poc] = calc_acdc(planes)
        # picture lambda per the reference's exact model (hierarchy-depth
        # multiplier + I-slice GOP scale, TEncSlice.cpp:335-371)
        pic_lam = hm_pic_lambda(slice_qp, self.gop_size or 1, cvs_poc,
                                qf, is_intra)
        # force-all lossless: every sample is bypass-coded, so loop
        # filters cannot change anything (reference TComLoopFilter
        # bPartP/QNoFilter + SAO offsetBlock lossless skip) — SAO off
        # saves its signalling
        lossless = bool(getattr(cfg, "tq_bypass_force", 0))
        sao_on = 1 if (cfg.sao and not lossless) else 0
        cfmt = self.sps.chroma_format_idc
        use_native = (not lossless
                      and (cfmt == 1 or (cfmt == 3 and is_intra)) and
                      os.environ.get("HEVC_TPU_NATIVE_RECON", "1") != "0")
        n_l0 = 0 if is_intra else len(ref_l0)
        n_l1 = len(ref_l1) if is_b and ref_l1 else 0
        sh = SliceHeader(
            slice_type=stype,
            nal_unit_type=int(NalUnitType.IDR_W_RADL if idr
                              else NalUnitType.TRAIL_R),
            poc=cvs_poc, slice_qp=slice_qp,
            slice_sao_luma_flag=sao_on,
            slice_sao_chroma_flag=(sao_on if cfmt != 0 else 0),
            short_term_ref_pic_set_sps_flag=1 if use_sps_rps else 0,
            rps_sps_idx=rps_sps_idx, rps=rps,
            five_minus_max_num_merge_cand=5 - cfg.max_merge_cand,
            num_ref_idx_active=[n_l0, n_l1])

        ctu_qps = None
        if self.pps.cu_qp_delta_enabled_flag:
            # target QP map at quantization-group granularity
            # (ctu >> diff_cu_qp_delta_depth; per-CTU when depth 0)
            dqd = self.pps.diff_cu_qp_delta_depth
            qg = self.sps.ctu_size >> dqd
            if cfg.lcu_rate_control and self.rc is not None:
                from .rate_ctrl import lcu_qps
                refl = None if is_intra else ref_l0[0][1][0]
                m = lcu_qps(planes[0], refl, self.sps.ctu_size, slice_qp,
                            wpp=bool(
                                self.pps.entropy_coding_sync_enabled_flag))
                if dqd:
                    # rate control allocates per CTU; replicate to QGs
                    qgs_h = -(-cfg.height // qg)
                    qgs_w = -(-cfg.width // qg)
                    m = np.repeat(np.repeat(m, 1 << dqd, 0), 1 << dqd,
                                  1)[:qgs_h, :qgs_w]
                ctu_qps = m.reshape(-1)
            else:
                from ..ops.qpmap import adaptive_qp_offsets
                ctu_qps = adaptive_qp_offsets(
                    planes[0], qg, slice_qp,
                    cfg.qp_adaptation_range).reshape(-1)
        if is_intra:
            sp = make_slice_params(
                cfg.width, cfg.height, slice_qp, slice_type=int(stype),
                ctu_size=self.sps.ctu_size,
                max_tu_depth_intra=self.sps.max_transform_hierarchy_depth_intra,
                max_tu_depth_inter=self.sps.max_transform_hierarchy_depth_inter,
                chroma_format=self.sps.chroma_format_idc,
                sign_hiding=self.pps.sign_data_hiding_enabled_flag,
                sao_luma=sao_on,
                sao_chroma=(sao_on if cfmt != 0 else 0),
                bit_depth=self.sps.bit_depth_luma,
                scaling_lists=self.sps.scaling_list_enabled_flag,
                transform_skip=self.pps.transform_skip_enabled_flag,
                cu_dqp=self.pps.cu_qp_delta_enabled_flag, ctu_qps=ctu_qps,
                pcm=self.sps.pcm_enabled_flag,
                wpp=self.pps.entropy_coding_sync_enabled_flag,
                tile_cols=self.pps.num_tile_columns_minus1 + 1
                if self.pps.tiles_enabled_flag else 0,
                tile_rows=self.pps.num_tile_rows_minus1 + 1
                if self.pps.tiles_enabled_flag else 0)
            sp.ts_rotation = self.sps.transform_skip_rotation_enabled_flag
            sp.implicit_rdpcm = self.sps.implicit_rdpcm_enabled_flag
            sp.explicit_rdpcm = self.sps.explicit_rdpcm_enabled_flag
            sp.dqp_depth = self.pps.diff_cu_qp_delta_depth
            sp.ccp = self.pps.cross_component_prediction_enabled_flag
            sp.rdoq_off = 0 if cfg.rdoq else 1
            sp.rdoq_ts_off = 0 if cfg.rdoq_ts else 1
            sp.cip = self.pps.constrained_intra_pred_flag
            sp.log2_par_merge = (
                self.pps.log2_parallel_merge_level_minus2 + 2)
            sp.cqp_off[0] = self.pps.pps_cb_qp_offset
            sp.cqp_off[1] = self.pps.pps_cr_qp_offset
            sp.tq_bypass = self.pps.transquant_bypass_enabled_flag
            sp.ts_context = self.sps.transform_skip_context_enabled_flag
            sp.persistent_rice = \
                self.sps.persistent_rice_adaptation_enabled_flag
            sp.bypass_align = self.sps.cabac_bypass_alignment_enabled_flag
            # reference-GPU-mode ME reproduction (cfg GPUModeME): the
            # engine computes per-CTU 593-partition full-search tables
            # at the 2Nx2N predictor and serves sub-PU lookups from
            # them (reference TEncSearch.cpp:3743-3770; semantics in
            # ops/me_gpu_mode.py)
            sp.gpu_mode_me = int(getattr(cfg, "gpu_mode_me", 0) or 0)
            sp.gpu_sr = cfg.search_range
            senc = SliceDataEncoder(sp, self.sps.bit_depth_luma > 14)
            if sh.slice_temporal_mvp_enabled_flag:
                from ..entropy.cabac import set_collocated
                set_collocated(senc, self.dpb_motion[l0_poc], True)
            if use_native:
                from .native_frame import NativeFrameEncoder
                scr = (self._intra_screen_q.popleft()
                       if self._intra_screen_q else None)
                fe = NativeFrameEncoder(self.sps, slice_qp, senc, sp,
                                        intra_screen=scr, lam=pic_lam,
                                        device=self.device)
            else:
                fe = IntraFrameEncoder(self.sps, slice_qp, lam=pic_lam)
                fe.cqp_off = (self.pps.pps_cb_qp_offset,
                              self.pps.pps_cr_qp_offset)
                fe.lossless = lossless
            ref_pocs = ((), ())
        else:
            l0_poc, l0_planes = ref_l0[0]
            wp_active = ((self.pps.weighted_pred_flag and not is_b)
                         or (self.pps.weighted_bipred_flag and is_b))
            if wp_active:
                # WeightPredAnalysis (reference WeightPredAnalysis.cpp:
                # whole-picture AC/DC fit per reference and component,
                # iterative denom reduction, SAD-gated selection). P
                # slices analyse list 0; B slices (weighted_bipred_flag)
                # analyse both lists; identity components per ref stay
                # unsignalled.
                from .wp_analysis import analyse_wp, calc_acdc
                cur_acdc = self._wp_acdc.get(cvs_poc) or calc_acdc(planes)

                lists = [ref_l0] + ([ref_l1] if (is_b and ref_l1) else [])
                ref_acdcs, ref_recs, counts = [], [], []
                ok = True
                for refs in lists:
                    counts.append(len(refs))
                    for (rp, rplanes) in refs:
                        ra = self._wp_acdc.get(rp)
                        if ra is None:
                            ok = False
                            break
                        ref_acdcs.append(ra)
                        ref_recs.append(rplanes)
                if ok:
                    # one joint fit over the concatenated lists so both
                    # share the signalled denom (the pred_weight_table
                    # carries a single luma/chroma denom pair)
                    denom, tables = analyse_wp(
                        cur_acdc, ref_acdcs, planes, ref_recs,
                        self.sps.bit_depth_luma, counts[0])

                    def wp_set(t):
                        if t is None:
                            return None
                        (wy, oy_), (wcb, ocb), (wcr, ocr) = t
                        luma = ((wy, oy_)
                                if (wy, oy_) != (1 << denom, 0) else None)
                        chroma = (((wcb, ocb), (wcr, ocr))
                                  if ((wcb, ocb) != (1 << denom, 0)
                                      or (wcr, ocr) != (1 << denom, 0))
                                  else None)
                        return (luma, chroma) if (luma or chroma) else None

                    sets = tuple(wp_set(t) for t in (tables or []))
                    s0 = sets[:counts[0]]
                    s1 = sets[counts[0]:] if len(counts) > 1 else ()
                    if any(s0) or any(s1):
                        sh.wp_log2_denom = denom
                        sh.wp_chroma_log2_denom = denom
                        if any(s0):
                            sh.wp_l0 = s0
                        if any(s1):
                            sh.wp_l1 = s1
            sp = make_slice_params(
                cfg.width, cfg.height, slice_qp, slice_type=int(stype),
                ctu_size=self.sps.ctu_size,
                max_tu_depth_intra=self.sps.max_transform_hierarchy_depth_intra,
                max_tu_depth_inter=self.sps.max_transform_hierarchy_depth_inter,
                chroma_format=self.sps.chroma_format_idc,
                sign_hiding=self.pps.sign_data_hiding_enabled_flag,
                amp=self.sps.amp_enabled_flag,
                scaling_lists=self.sps.scaling_list_enabled_flag,
                transform_skip=self.pps.transform_skip_enabled_flag,
                cu_dqp=self.pps.cu_qp_delta_enabled_flag, ctu_qps=ctu_qps,
                pcm=self.sps.pcm_enabled_flag,
                num_ref_l0=n_l0, num_ref_l1=n_l1,
                max_merge_cand=cfg.max_merge_cand,
                ref_poc_l0=[p for p, _ in ref_l0],
                ref_poc_l1=[p for p, _ in ref_l1] if is_b else [],
                sao_luma=sao_on,
                sao_chroma=(sao_on if cfmt != 0 else 0),
                bit_depth=self.sps.bit_depth_luma, cur_poc=cvs_poc,
                wpp=self.pps.entropy_coding_sync_enabled_flag,
                tile_cols=self.pps.num_tile_columns_minus1 + 1
                if self.pps.tiles_enabled_flag else 0,
                tile_rows=self.pps.num_tile_rows_minus1 + 1
                if self.pps.tiles_enabled_flag else 0)
            # TMVP collocated picture (spec 8.5.3.2.8-9): P slices use
            # L0[0]; B slices alternate the list per coded picture within
            # a GOP exactly as the reference's uiColDir toggle
            # (TEncGOP::compressGOP, TEncGOP.cpp:1271 setColFromL0Flag
            # (1-uiColDir) with uiColDir starting at 1 per GOP batch) —
            # so the first B of a hierarchical GOP collocates with the
            # motion-rich L1 picture instead of a motionless I frame,
            # which feeds bi-predictive TMVP merge candidates.
            gop_n = max(1, self.gop_size or 1)
            batch = 0 if cvs_poc == 0 else (cvs_poc - 1) // gop_n + 1
            if batch != self._col_batch:
                self._col_batch = batch
                self._col_dir = 1
            col_from_l0 = (1 - self._col_dir) if is_b else 1
            col_poc = (l0_poc if col_from_l0 else ref_l1[0][0]) \
                if (col_from_l0 or ref_l1) else l0_poc
            use_tmvp = (self.sps.sps_temporal_mvp_enabled_flag
                        and col_poc in self.dpb_motion)
            sh.slice_temporal_mvp_enabled_flag = 1 if use_tmvp else 0
            sh.collocated_from_l0_flag = col_from_l0
            sp.col_from_l0 = col_from_l0
            wp_l0 = sh.wp_l0
            if not wp_l0 and (sh.wp_luma_flag or sh.wp_chroma_flag):
                wp_l0 = ((
                    (sh.wp_weight, sh.wp_offset) if sh.wp_luma_flag
                    else None,
                    sh.wp_chroma if sh.wp_chroma_flag else None),)
            wp_l1 = getattr(sh, "wp_l1", ())
            if any(wp_l0) or any(wp_l1):
                sp.wp_on = 1
                sp.wp_denom = sh.wp_log2_denom
                sp.wp_cdenom = sh.wp_chroma_log2_denom
                for (tab, ws, os_, cws, cos) in (
                        (wp_l0, sp.wp_w, sp.wp_o, sp.wp_cw, sp.wp_co),
                        (wp_l1, sp.wp_w1, sp.wp_o1, sp.wp_cw1,
                         sp.wp_co1)):
                    for r in range(16):
                        t = tab[r] if r < len(tab) else None
                        luma = t[0] if t else None
                        chroma = t[1] if t else None
                        ws[r] = (luma[0] if luma
                                 else 1 << sh.wp_log2_denom)
                        os_[r] = luma[1] if luma else 0
                        for j in range(2):
                            cwj, coj = (chroma[j] if chroma else
                                        (1 << sh.wp_chroma_log2_denom, 0))
                            cws[2 * r + j] = cwj
                            cos[2 * r + j] = coj
            sp.ts_rotation = self.sps.transform_skip_rotation_enabled_flag
            sp.implicit_rdpcm = self.sps.implicit_rdpcm_enabled_flag
            sp.explicit_rdpcm = self.sps.explicit_rdpcm_enabled_flag
            sp.dqp_depth = self.pps.diff_cu_qp_delta_depth
            sp.ccp = self.pps.cross_component_prediction_enabled_flag
            sp.rdoq_off = 0 if cfg.rdoq else 1
            sp.rdoq_ts_off = 0 if cfg.rdoq_ts else 1
            sp.cip = self.pps.constrained_intra_pred_flag
            sp.log2_par_merge = (
                self.pps.log2_parallel_merge_level_minus2 + 2)
            sp.cqp_off[0] = self.pps.pps_cb_qp_offset
            sp.cqp_off[1] = self.pps.pps_cr_qp_offset
            sp.tq_bypass = self.pps.transquant_bypass_enabled_flag
            sp.ts_context = self.sps.transform_skip_context_enabled_flag
            sp.persistent_rice = \
                self.sps.persistent_rice_adaptation_enabled_flag
            sp.bypass_align = self.sps.cabac_bypass_alignment_enabled_flag
            # reference-GPU-mode ME reproduction (cfg GPUModeME): the
            # engine computes per-CTU 593-partition full-search tables
            # at the 2Nx2N predictor and serves sub-PU lookups from
            # them (reference TEncSearch.cpp:3743-3770; semantics in
            # ops/me_gpu_mode.py)
            sp.gpu_mode_me = int(getattr(cfg, "gpu_mode_me", 0) or 0)
            sp.gpu_sr = cfg.search_range
            senc = SliceDataEncoder(sp, self.sps.bit_depth_luma > 14)
            if sh.slice_temporal_mvp_enabled_flag:
                from ..entropy.cabac import set_collocated
                set_collocated(senc, self.dpb_motion[col_poc], True)
            if use_native:
                from .native_frame import NativeFrameEncoder
                # luma WP triples per list-0/1 reference from the slice
                # header's analysed weight sets: the integer search runs
                # on the weighted reference (weighted distortion,
                # reference TComRdCostWeightPrediction)
                denom = sh.wp_log2_denom

                def _wp_triples(sets, n):
                    out = [None] * n
                    for i, t in enumerate(sets or ()):
                        if i < n and t is not None and t[0] is not None:
                            out[i] = (t[0][0], t[0][1], denom)
                    return out if any(out) else None
                wp0 = _wp_triples(sh.wp_l0, len(ref_l0))
                wp1 = (_wp_triples(sh.wp_l1, len(ref_l1))
                       if is_b else None)
                if os.environ.get("HEVC_TPU_ME_WP", "1") == "0":
                    wp0 = wp1 = None  # unweighted search (A/B testing)
                me_pre = self._me_pending_take(
                    display_poc, ref_l0, ref_l1 if is_b else None,
                    int(65536.0 * math.sqrt(pic_lam)),
                    self.sps.ctu_size >> 1, cfg.search_range,
                    self.sps.bit_depth_luma)
                if me_pre is not None and (wp0 or wp1):
                    # the prefetched search ran unweighted; a faded
                    # frame re-searches with weights applied
                    me_pre = None
                fe = NativeFrameEncoder(
                    self.sps, slice_qp, senc, sp, qp_factor=qf, is_b=is_b,
                    lam=pic_lam,
                    ref_planes=[self._padded_ref(p, pl)
                                for p, pl in ref_l0],
                    ref1_planes=[self._padded_ref(p, pl)
                                 for p, pl in ref_l1] if is_b else None,
                    refs_padded=True,
                    search_range=cfg.search_range,
                    me_provider=(
                        (lambda size, r, lam:
                         self.me_provider(display_poc, size, r, lam))
                        if self.me_provider else None),
                    me_prefetch=me_pre,
                    ref_pocs=[p for p, _ in ref_l0],
                    ref1_pocs=[p for p, _ in ref_l1] if is_b else None,
                    ref_dev=[self._dev_ref(p, pl) for p, pl in ref_l0],
                    ref1_dev=[self._dev_ref(p, pl) for p, pl in ref_l1]
                    if is_b else None,
                    mesh=self.mesh, mesh_axis=self.mesh_axis,
                    wp0=wp0, wp1=wp1, device=self.device)
            else:
                # pure-Python reference path: single reference per list
                fe = PFrameEncoder(self.sps, slice_qp, l0_planes,
                                   search_range=cfg.search_range,
                                   qp_factor=qf, is_b=is_b, lam=pic_lam,
                                   ref1_planes=ref_l1[0][1] if is_b
                                   else None, device=self.device)
                fe.senc = senc
                fe.cqp_off = (self.pps.pps_cb_qp_offset,
                              self.pps.pps_cr_qp_offset)
                fe.lossless = lossless
            ref_pocs = ([p for p, _ in ref_l0],
                        [p for p, _ in ref_l1] if is_b else [])

        # multi-slice partition (SliceMode 1: SliceArgument CTUs per
        # slice, reference TEncSlice::xDetermineStartAndBoundingCtuTsAddr)
        slice_objs = None
        ctus_w = self.sps.pic_width_in_ctus
        ctus_h = self.sps.pic_height_in_ctus
        if cfg.slice_mode in (1, 2, 3) and use_native:
            from ..entropy.cabac import SliceParamsC, tile_scan_order
            if cfg.slice_mode == 3:
                # slices made of whole tiles (reference TypeDef.h:581
                # FIXED_NUMBER_OF_TILES): partition the TILE-scan walk
                raster = tile_scan_order(
                    cfg.width, cfg.height, self.sps.ctu_size,
                    self.pps.num_tile_columns_minus1 + 1,
                    self.pps.num_tile_rows_minus1 + 1)
            else:
                raster = [(x, y) for y in range(ctus_h)
                          for x in range(ctus_w)]
            n_all = len(raster)

            def _mk_slices(bounds, reuse_first=True):
                objs = []
                for s0, cnt in bounds:
                    ctus = raster[s0:s0 + cnt]
                    start_rs = ctus[0][1] * ctus_w + ctus[0][0]
                    if s0 == 0 and reuse_first:
                        spi, senc_i = sp, senc
                    else:
                        spi = SliceParamsC.from_buffer_copy(sp)
                        spi.slice_start_ctu = start_rs
                        senc_i = SliceDataEncoder(spi, self.sps.bit_depth_luma > 14)
                        if sh.slice_temporal_mvp_enabled_flag:
                            from ..entropy.cabac import set_collocated
                            set_collocated(senc_i,
                                           self.dpb_motion[col_poc], True)
                    objs.append((spi, senc_i, ctus))
                return objs

            if cfg.slice_mode == 3:
                # group SliceArgument whole tiles per slice; tile start
                # indices in the tile-scan walk are the cumulative
                # uniform-grid tile areas (spec 6.5.1)
                tcols = self.pps.num_tile_columns_minus1 + 1
                trows = self.pps.num_tile_rows_minus1 + 1
                xs = [i * ctus_w // tcols for i in range(tcols)] + [ctus_w]
                ys = [i * ctus_h // trows for i in range(trows)] + [ctus_h]
                starts, acc = [0], 0
                for r in range(trows):
                    for c in range(tcols):
                        acc += (ys[r + 1] - ys[r]) * (xs[c + 1] - xs[c])
                        starts.append(acc)
                arg = max(1, cfg.slice_argument)
                bounds = []
                ti = 0
                while ti < len(starts) - 1:
                    last = min(ti + arg, len(starts) - 1)
                    bounds.append((starts[ti], starts[last] - starts[ti]))
                    ti = last
            elif cfg.slice_mode == 1:
                arg = max(1, cfg.slice_argument)
                bounds = [(s0, min(arg, n_all - s0))
                          for s0 in range(0, n_all, arg)]
            else:
                # SliceMode 2 (bytes per slice, reference
                # TEncSlice::compressSlice slice-byte-limit termination):
                # greedy prefix — compress with the open slice covering
                # the rest of the picture, entropy-code it until the
                # byte budget trips, cut there, repeat. Boundaries are
                # decided pre-SAO, as the reference decides them at
                # compress time; each already-coded prefix byte is
                # invariant to where the slice later ends.
                from ..entropy.cabac import (
                    entropy_encode_frame_order_budget)
                budget = max(1, cfg.slice_argument)
                bounds, s0 = [], 0
                while True:
                    cand = bounds + [(s0, n_all - s0)]
                    objs = _mk_slices(cand, reuse_first=False)
                    dec_t, _ = fe.encode_frame(planes, slices=objs)
                    spi_t, senc_t, ctus_t = objs[-1]
                    ncod = entropy_encode_frame_order_budget(
                        senc_t, ctus_t, ctus_w, dec_t, budget)
                    if ncod >= len(ctus_t):
                        bounds = cand
                        break
                    bounds.append((s0, ncod))
                    s0 += ncod
            slice_objs = _mk_slices(bounds)
        if slice_objs is not None:
            decisions, recon = fe.encode_frame(planes, slices=slice_objs)
        else:
            decisions, recon = fe.encode_frame(planes)

        # Dispatch the pending next-frame integer search against THIS
        # frame's pre-loop-filter luma as soon as the engine hands it
        # over: the search gains deblock+SAO+entropy of host overlap (a
        # full tunnel round trip when the device is remote-attached).
        # Only the integer-MV *choice* sees the unfiltered samples; the
        # engine's fractional refine and MC always use the final DPB
        # reference, so conformance is untouched and the MV quality
        # delta is the few samples deblock/SAO move. (The reference
        # searches filtered refs — TEncGOP calls GPU ME after the loop
        # filters — at the cost of serializing against them.)
        if self.cfg.intra_period != 1 and not idr:
            with timers.loop_span("ref_prep"):
                self._me_pending_early_dispatch(cvs_poc, recon[0])

        # in-loop deblocking
        if (not self.pps.pps_deblocking_filter_disabled_flag
                and not lossless):
            from ..ops import deblock
            qmap = None
            if self.pps.cu_qp_delta_enabled_flag and ctu_qps is not None:
                from ..entropy.cabac import tile_scan_order
                from ..ops import qpmap
                cfgw, cfgh = cfg.width, cfg.height
                order = tile_scan_order(
                    cfgw, cfgh, self.sps.ctu_size,
                    self.pps.num_tile_columns_minus1 + 1
                    if self.pps.tiles_enabled_flag else 0,
                    self.pps.num_tile_rows_minus1 + 1
                    if self.pps.tiles_enabled_flag else 0)
                ctus_w = self.sps.pic_width_in_ctus
                ctus_h = self.sps.pic_height_in_ctus
                get_d = (decisions.view if hasattr(decisions, "view")
                         else lambda i: decisions[i])
                tcols = (self.pps.num_tile_columns_minus1 + 1
                         if self.pps.tiles_enabled_flag else 0)
                trows = (self.pps.num_tile_rows_minus1 + 1
                         if self.pps.tiles_enabled_flag else 0)
                if self.pps.diff_cu_qp_delta_depth:
                    qmap = qpmap.qg_qp_map(
                        get_d, order, ctu_qps, slice_qp,
                        self.sps.ctu_size,
                        self.pps.diff_cu_qp_delta_depth, cfgw, cfgh,
                        wpp=self.pps.entropy_coding_sync_enabled_flag,
                        tile_cols=tcols, tile_rows=trows,
                        chroma_format=self.sps.chroma_format_idc)
                else:
                    has = [qpmap.ctu_has_cbf(get_d(cy * ctus_w + cx))
                           for (cx, cy) in order]
                    pred, fin = qpmap.qp_chain(
                        ctu_qps, has, slice_qp, order, ctus_w, ctus_h,
                        wpp=self.pps.entropy_coding_sync_enabled_flag,
                        tile_cols=tcols, tile_rows=trows)
                    qmap = qpmap.build_qp_map(get_d, order, pred, fin,
                                              self.sps.ctu_size, cfgw,
                                              cfgh)
            with timers.section("deblock"):
                if os.environ.get("HEVC_TPU_NATIVE_DEBLOCK", "1") != "0":
                    from ..entropy.cabac import deblock_frame_native
                    recon = deblock_frame_native(
                        recon, decisions, self.sps, slice_qp, ref_pocs,
                        qp_map=qmap,
                        cb_qp_offset=self.pps.pps_cb_qp_offset,
                        cr_qp_offset=self.pps.pps_cr_qp_offset)
                else:
                    dmaps = deblock.build_maps(decisions, self.sps,
                                               ref_pocs)
                    deblock.deblock_frame(
                        recon, dmaps, slice_qp, self.sps, qp_map=qmap,
                        cb_qp_offset=self.pps.pps_cb_qp_offset,
                        cr_qp_offset=self.pps.pps_cr_qp_offset)

        # SAO: estimate on deblocked, attach params, apply after coding
        if sao_on:
            from ..ops import sao as saolib
            lam = pic_lam
            if use_native:
                from ..entropy.cabac import sao_estimate_native
                with timers.section("sao"):
                    sids = None
                    if slice_objs is not None and len(slice_objs) > 1:
                        sids = np.zeros(ctus_w * ctus_h, np.int32)
                        for si, (_s, _e, ctus) in enumerate(slice_objs):
                            for (cx, cy) in ctus:
                                sids[cy * ctus_w + cx] = si
                    sao_params = sao_estimate_native(
                        planes, recon, self.sps, self.sps.bit_depth_luma,
                        lam, slice_ids=sids)
            else:
                sao_params = saolib.estimate_sao(
                    planes, recon, self.sps, self.sps.bit_depth_luma, lam)
            for d, prm in zip(decisions, sao_params):
                d.sao[:] = prm

        from ..entropy.cabac import (FrameDecisions, entropy_encode_frame,
                                     entropy_encode_frame_order,
                                     tile_scan_order)
        slice_rbsps = None
        if slice_objs is not None and len(slice_objs) > 1:
            # one coded slice segment per partition (SliceMode 1)
            import dataclasses as _dc
            slice_rbsps = []
            with timers.section("entropy"):
                for si, (spi, senc_i, ctus) in enumerate(slice_objs):
                    entropy_encode_frame_order(senc_i, ctus, ctus_w,
                                               decisions)
                    sh_i = _dc.replace(
                        sh, first_slice_segment_in_pic_flag=1 if si == 0
                        else 0,
                        slice_segment_address=spi.slice_start_ctu,
                        entry_point_offsets=[])
                    data_i = senc_i.get_bytes()
                    if self.pps.tiles_enabled_flag:
                        # entry points for the tiles within this slice
                        # (SliceMode 3 with SliceArgument > 1)
                        from ..entropy.cabac import _encoder_substreams
                        sizes = _encoder_substreams(senc_i)
                        if len(sizes) > 1:
                            for _ in range(5):
                                hdr = headers.write_slice_header(
                                    sh_i, self.sps, self.pps)
                                bnds = [len(hdr)]
                                acc = len(hdr)
                                for sz in sizes[:-1]:
                                    acc += sz
                                    bnds.append(acc)
                                esc = nal.escaped_sizes(hdr + data_i, bnds)
                                offs = esc[:-1] if len(esc) > 1 else []
                                if offs == sh_i.entry_point_offsets:
                                    break
                                sh_i.entry_point_offsets = offs
                    slice_rbsps.append(
                        headers.write_slice_header(sh_i, self.sps,
                                                   self.pps) + data_i)
        if (slice_rbsps is None and cfg.slice_segment_mode == 3
                and self.pps.tiles_enabled_flag
                and use_native and isinstance(decisions, FrameDecisions)):
            # tile-aligned dependent slice segments (reference
            # TEncSlice::xDetermineStartAndBoundingCtuTsAddr,
            # FIXED_NUMBER_OF_TILES, TEncSlice.cpp:1205): every segment
            # carries SliceSegmentArgument whole tiles; its last CTU
            # codes end_of_slice_segment_flag=1 + flush (native
            # frame_order_tileseg), so the cut payloads are directly
            # the dependent segments' slice data
            import dataclasses as _dc
            from ..entropy.cabac import (_encoder_substreams,
                                         entropy_encode_frame_order_tilesegs)
            tc = self.pps.num_tile_columns_minus1 + 1
            tr = self.pps.num_tile_rows_minus1 + 1
            # uniform tile grid geometry (spec 6.5.1, same derivation as
            # tile_scan_order): CTU counts + first raster address per tile
            xs = [i * ctus_w // tc for i in range(tc)] + [ctus_w]
            ys = [i * ctus_h // tr for i in range(tr)] + [ctus_h]
            tile_addr = [ys[r] * ctus_w + xs[c]
                         for r in range(tr) for c in range(tc)]
            tile_ctus = [(ys[r + 1] - ys[r]) * (xs[c + 1] - xs[c])
                         for r in range(tr) for c in range(tc)]
            seg_arg = max(1, cfg.slice_segment_argument)
            ntiles = tc * tr
            seg_tiles = [list(range(i, min(i + seg_arg, ntiles)))
                         for i in range(0, ntiles, seg_arg)]
            cum = np.cumsum(tile_ctus).tolist()
            bounds = [cum[g[-1]] for g in seg_tiles]
            with timers.section("entropy"):
                order = tile_scan_order(cfg.width, cfg.height,
                                        self.sps.ctu_size, tc, tr)
                marks = entropy_encode_frame_order_tilesegs(
                    senc, order, ctus_w, decisions, bounds)
                seg_data = senc.get_bytes()
                sizes = _encoder_substreams(senc)
            slice_rbsps = []
            bpos = 0
            for i, tiles_i in enumerate(seg_tiles):
                end_b = marks[i] if marks[i] >= 0 else len(seg_data)
                payload = seg_data[bpos:end_b]
                bpos = end_b
                sh_i = _dc.replace(
                    sh,
                    first_slice_segment_in_pic_flag=1 if i == 0 else 0,
                    dependent_slice_segment_flag=0 if i == 0 else 1,
                    slice_segment_address=tile_addr[tiles_i[0]],
                    entry_point_offsets=[])
                if len(tiles_i) > 1:
                    # interior tile boundaries within this segment need
                    # entry points (spec 7.4.7.1); escaped sizes depend on
                    # the header length, so iterate to the fixed point
                    for _ in range(5):
                        hdr = headers.write_slice_header(sh_i, self.sps,
                                                         self.pps)
                        bnds, acc = [len(hdr)], len(hdr)
                        for t in tiles_i[:-1]:
                            acc += sizes[t]
                            bnds.append(acc)
                        esc = nal.escaped_sizes(hdr + payload, bnds)
                        offs = esc[:-1] if len(esc) > 1 else []
                        if offs == sh_i.entry_point_offsets:
                            break
                        sh_i.entry_point_offsets = offs
                slice_rbsps.append(
                    headers.write_slice_header(sh_i, self.sps, self.pps)
                    + payload)
        if (slice_rbsps is None and cfg.slice_segment_mode in (1, 2)
                and use_native and isinstance(decisions, FrameDecisions)):
            # dependent slice segments: one entropy pass over the slice,
            # cut whenever the CTU/byte limit trips; contexts continue
            # (native segment_cut) and every segment after the first
            # carries the short dependent header (spec 7.3.6.1)
            import dataclasses as _dc
            from ..entropy.cabac import entropy_encode_frame_order_segments
            with timers.section("entropy"):
                rorder = [(x, y) for y in range(ctus_h)
                          for x in range(ctus_w)]
                seg_counts, marks = entropy_encode_frame_order_segments(
                    senc, rorder, ctus_w, decisions,
                    cfg.slice_segment_mode,
                    max(1, cfg.slice_segment_argument))
                seg_data = senc.get_bytes()
            slice_rbsps = []
            bpos, addr = 0, 0
            for i, cnt in enumerate(seg_counts):
                end_b = marks[i] if marks[i] >= 0 else len(seg_data)
                sh_i = _dc.replace(
                    sh,
                    first_slice_segment_in_pic_flag=1 if i == 0 else 0,
                    dependent_slice_segment_flag=0 if i == 0 else 1,
                    slice_segment_address=addr,
                    entry_point_offsets=[])
                slice_rbsps.append(
                    headers.write_slice_header(sh_i, self.sps, self.pps)
                    + seg_data[bpos:end_b])
                bpos, addr = end_b, addr + cnt
        data = b""
        if slice_rbsps is None and cfg.slice_segment_mode in (1, 2, 3):
            # configured segmentation needs the native entropy path;
            # cfg.validate() rejects the static conflicts (lossless), so
            # reaching here means a debug override (HEVC_TPU_NATIVE_RECON=0)
            # — say so instead of silently emitting one slice
            import warnings
            warnings.warn(
                f"SliceSegmentMode {cfg.slice_segment_mode} configured but "
                "the native recon path is disabled; emitting a single "
                "slice segment", RuntimeWarning)
        if slice_rbsps is None:
            with timers.section("entropy"):
                if isinstance(decisions, FrameDecisions):
                    if self.pps.tiles_enabled_flag:
                        order = tile_scan_order(
                            cfg.width, cfg.height, self.sps.ctu_size,
                            self.pps.num_tile_columns_minus1 + 1,
                            self.pps.num_tile_rows_minus1 + 1)
                        entropy_encode_frame_order(senc, order, ctus_w,
                                                   decisions)
                    else:
                        entropy_encode_frame(senc, ctus_w, ctus_h,
                                             decisions)
                else:
                    i = 0
                    for cy in range(ctus_h):
                        for cx in range(ctus_w):
                            last = (cy == ctus_h - 1) and \
                                (cx == ctus_w - 1)
                            senc.encode_ctu(cx, cy, decisions[i], last)
                            i += 1
                data = senc.get_bytes()
        with timers.loop_span("stream_write"):
            if slice_rbsps is None and (
                    self.pps.entropy_coding_sync_enabled_flag
                    or self.pps.tiles_enabled_flag):
                # WPP entry points (spec 7.4.7.1): offsets are NAL-payload
                # byte counts (incl. emulation prevention); the header
                # length feeds back into the escape scan, so iterate to
                # the fixed point
                from ..entropy.cabac import _encoder_substreams
                sizes = _encoder_substreams(senc)
                for _ in range(5):
                    hdr = headers.write_slice_header(sh, self.sps, self.pps)
                    bounds = [len(hdr)]
                    acc = len(hdr)
                    for sz in sizes[:-1]:
                        acc += sz
                        bounds.append(acc)
                    esc = nal.escaped_sizes(hdr + data, bounds)
                    offs = esc[:-1] if len(esc) > 1 else []
                    if offs == sh.entry_point_offsets:
                        break
                    sh.entry_point_offsets = offs
            if slice_rbsps is None:
                slice_rbsps = [headers.write_slice_header(
                    sh, self.sps, self.pps) + data]

        if sao_on:
            if use_native:
                from ..entropy.cabac import sao_apply_native
                with timers.section("sao"):
                    recon = sao_apply_native(
                        recon, decisions.sao
                        if isinstance(decisions, FrameDecisions)
                        else [d.sao for d in decisions], self.sps,
                        self.sps.bit_depth_luma)
            else:
                recon = saolib.apply_sao(recon,
                                         [d.sao for d in decisions],
                                         self.sps, self.sps.bit_depth_luma)

        # the recon is final here: upload it and dispatch any pending
        # next-frame search against it NOW, so the device computes under
        # the whole NAL/SEI/hash/stats host tail below (for IDR frames the
        # DPB reset below re-uploads — intra frames have no pending search)
        if self.cfg.intra_period != 1 and not idr:
            with timers.loop_span("ref_prep"):
                self._dev_ref(cvs_poc, recon)
                self._me_pending_late_dispatch(cvs_poc)

        with timers.loop_span("stream_write"):
            nals, firsts, digest = self._au_nals(
                sh, slice_rbsps, recon, idr=idr, display_poc=display_poc,
                cvs_poc=cvs_poc)

        bits = sum(len(x) for x in nals) * 8
        with timers.section("hash_psnr"):
            if self.sps.chroma_format_idc == 0:
                # monochrome: luma PSNR only (chroma reported as 0 like
                # the reference's zero-MSE guard output)
                psnr = _psnr(planes[:1], recon[:1],
                             self.sps.bit_depth_luma) + [0.0, 0.0]
            else:
                psnr = _psnr(planes, recon, self.sps.bit_depth_luma)
        self.stats.append({"poc": display_poc, "bits": bits, "psnr": psnr,
                           "md5": digest[0].hex(), "qp": slice_qp,
                           "type": stype.name})
        if self.rc:
            self.rc.update(bits)
        if idr:
            self.dpb.clear()
            self.dpb_motion.clear()
            self._dev_refs.clear()
            self._padded_refs.clear()
        if self.sps.sps_temporal_mvp_enabled_flag:
            from ..entropy.cabac import motion_field
            with timers.loop_span("motion_field"):
                self.dpb_motion[cvs_poc] = motion_field(
                    decisions, self.sps, ref_pocs[0], ref_pocs[1], cvs_poc)
        self.dpb[cvs_poc] = recon
        # upload the new reference now, so the next frame's motion search
        # finds it on the device
        if self.cfg.intra_period != 1:
            # the prefetched next-frame search was waiting for exactly
            # this recon — dispatch it now so it computes under the
            # remaining host work (entropy/hash/IO + next-frame setup)
            with timers.loop_span("ref_prep"):
                self._dev_ref(cvs_poc, recon)
                self._me_pending_late_dispatch(cvs_poc)
        # bounded DPB: evict pictures no future RPS can reference
        # (reference TComSlice::applyReferencePictureSet bumping)
        keep = self.gop_size + self._max_ref_delta
        top = max(self.dpb)
        for q in [q for q in self.dpb if q < top - keep]:
            del self.dpb[q]
            self.dpb_motion.pop(q, None)
            self._dev_refs.pop(q, None)
            self._padded_refs.pop(q, None)
        self.dpb_recon = recon
        self.recon = recon
        self.out_queue.append((display_poc, recon))
        # uiColDir flips after every coded picture (TEncGOP.cpp:1299)
        self._col_dir = 1 - self._col_dir
        with timers.loop_span("stream_write"):
            return nal.write_annexb(nals, firsts)

    def _au_nals(self, sh, slice_rbsps, recon, *, idr, display_poc,
                 cvs_poc):
        """The access unit's NAL units in order (parameter sets on the
        first, SEI, the slice segments, the decoded-picture hash), whether
        each starts with a four-byte start code, and the hash's digest."""
        cfg = self.cfg
        nals, firsts = [], []
        first_au = not self.stats
        if first_au:
            nals += [nal.rbsp_to_nal(headers.write_vps(self.vps),
                                     int(NalUnitType.VPS_NUT)),
                     nal.rbsp_to_nal(headers.write_sps(self.sps),
                                     int(NalUnitType.SPS_NUT)),
                     nal.rbsp_to_nal(headers.write_pps(self.pps),
                                     int(NalUnitType.PPS_NUT))]
            firsts += [True, True, True]
        if idr:
            # IRAP bookkeeping SEIs (reference SEIEncoder
            # initSEIActiveParameterSets / initSEIRecoveryPoint)
            nals.append(nal.rbsp_to_nal(
                sei.write_active_parameter_sets_sei(),
                int(NalUnitType.PREFIX_SEI_NUT)))
            firsts.append(False)
            nals.append(nal.rbsp_to_nal(
                sei.write_recovery_point_sei(0),
                int(NalUnitType.PREFIX_SEI_NUT)))
            firsts.append(False)
            for rb in self._idr_scope_seis():
                nals.append(nal.rbsp_to_nal(
                    rb, int(NalUnitType.PREFIX_SEI_NUT)))
                firsts.append(False)
        hrd = getattr(self.sps, "hrd", None)
        nested_seis = []  # copies for the scalable-nesting wrapper
        if hrd is not None and idr and cfg.sei_buffering_period:
            # 1-second nominal initial CPB removal delay in 90 kHz units
            bp_rbsp = sei.write_buffering_period_sei(hrd, 90000)
            nals.append(nal.rbsp_to_nal(
                bp_rbsp, int(NalUnitType.PREFIX_SEI_NUT)))
            firsts.append(False)
            self._au_count_since_bp = 0
            if cfg.sei_scalable_nesting:
                nested_seis.append(bp_rbsp)
        snals = [nal.rbsp_to_nal(rb, sh.nal_unit_type)
                 for rb in slice_rbsps]
        du_data = du_delays = None
        if (hrd is not None and getattr(hrd, "sub_pic", 0)
                and (cfg.sei_pic_timing or cfg.sei_decoding_unit_info)):
            du_data, du_delays = self._du_timing(nals, snals)
        if self.sps.vui_frame_field_info_present_flag or (
                hrd is not None and cfg.sei_pic_timing):
            # pic_struct 1 = top field, 2 = bottom field (Table D.2);
            # parity follows the display order and TopFieldFirst
            top = (display_poc % 2 == 0) == bool(self.cfg.top_field_first)
            ffi = bool(self.sps.vui_frame_field_info_present_flag)
            pt_rbsp = sei.write_pic_timing_sei(
                (1 if top else 2) if ffi else 0, source_scan_type=0,
                hrd=hrd if cfg.sei_pic_timing else None,
                cpb_removal_delay=self._au_count_since_bp,
                dpb_output_delay=self.gop_size +
                (display_poc - cvs_poc if self.reordered else 0),
                frame_field_info=ffi, du_data=du_data)
            nals.append(nal.rbsp_to_nal(
                pt_rbsp, int(NalUnitType.PREFIX_SEI_NUT)))
            firsts.append(False)
            if (cfg.sei_scalable_nesting and cfg.sei_pic_timing
                    and hrd is not None):
                nested_seis.append(pt_rbsp)
        if nested_seis:
            # scalable-nesting copy of the HRD bookkeeping SEIs for the
            # temporal sub-bitstream (reference TEncGOP
            # xCreateScalableNestingSEI + SEIEncoder
            # initSEIScalableNesting layer-0 form)
            nals.append(nal.rbsp_to_nal(
                sei.write_scalable_nesting_sei(nested_seis,
                                               bitstream_subset=True),
                int(NalUnitType.PREFIX_SEI_NUT)))
            firsts.append(False)
        self._au_count_since_bp += 1
        for rb in self._per_picture_seis(idr):
            nals.append(nal.rbsp_to_nal(
                rb, int(NalUnitType.PREFIX_SEI_NUT)))
            firsts.append(False)
        du_info_on = (du_delays is not None
                      and cfg.sei_decoding_unit_info)
        if du_info_on:
            # DU 0's decoding_unit_info rides with the leading SEIs;
            # each later DU's SEI precedes its slice NAL (reference
            # TEncGOP::xWriteDuSEIMessages)
            nals.append(nal.rbsp_to_nal(
                sei.write_decoding_unit_info_sei(0, du_delays[0] + 1,
                                                 hrd),
                int(NalUnitType.PREFIX_SEI_NUT)))
            firsts.append(False)
        for si, sn in enumerate(snals):
            if du_info_on and si > 0:
                nals.append(nal.rbsp_to_nal(
                    sei.write_decoding_unit_info_sei(
                        si, du_delays[si] + 1, hrd),
                    int(NalUnitType.PREFIX_SEI_NUT)))
                firsts.append(False)
            nals.append(sn)
            firsts.append(not first_au and si == 0)
        # decoded-picture-hash SEI; type per SEIDecodedPictureHash
        # (reference TComPicYuvMD5 calcMD5/CRC/checksum, TEncGOP.cpp:1661)
        ht = getattr(cfg, "hash_sei_type", 1)
        hash_planes = (recon[:1] if self.sps.chroma_format_idc == 0
                       else recon)  # mono hash covers luma only
        if ht == 2:
            digest = sei.picture_crc(hash_planes, self.sps.bit_depth_luma)
        elif ht == 3:
            digest = sei.picture_checksum(hash_planes,
                                          self.sps.bit_depth_luma)
        else:
            digest = sei.picture_md5(hash_planes, self.sps.bit_depth_luma)
        if ht:
            nals.append(nal.rbsp_to_nal(
                sei.write_picture_hash_sei(digest, {1: 0, 2: 1,
                                                    3: 2}.get(ht, 0)),
                int(NalUnitType.SUFFIX_SEI_NUT)))
            firsts.append(False)
        return nals, firsts, digest


def _psnr(orig, recon, bd):
    from ..entropy.cabac import get_lib
    lib = get_lib(bd > 14)
    dt = np.int16 if bd <= 14 else np.int32
    out = []
    peak = (1 << bd) - 1
    for o, r in zip(orig, recon):
        # exact int64 SSE in the native lib (vectorized; the float64
        # BLAS-dot route costs ~200 ms/frame at 1080p on slow hosts)
        a = np.ascontiguousarray(o, dt)
        b = np.ascontiguousarray(r, dt)
        sse = lib.hevc_plane_sse(a.ravel(), b.ravel(), a.size)
        mse = sse / a.size
        out.append(99.99 if mse == 0 else 10 * np.log10(peak * peak / mse))
    return out
