"""SEI messages — decoded picture hash (spec D.2.19/D.3.19).

Parity: reference SEIwrite.cpp + TComPicYuvMD5.cpp:185 (per-component MD5
over raster samples, low byte first for >8-bit).
"""
from __future__ import annotations

import hashlib
from typing import List

import numpy as np

from .bitwriter import BitWriter

DECODED_PICTURE_HASH = 132
ACTIVE_PARAMETER_SETS = 129
RECOVERY_POINT = 6
USER_DATA_UNREGISTERED = 5


def picture_md5(planes: List[np.ndarray], bit_depth: int = 8) -> List[bytes]:
    digests = []
    for p in planes:
        m = hashlib.md5()
        # numpy arrays expose the buffer protocol: hashing the array
        # directly avoids a full tobytes copy per plane on the hot loop
        if bit_depth <= 8:
            m.update(np.ascontiguousarray(p.astype(np.uint8)))
        else:
            m.update(np.ascontiguousarray(p.astype("<u2")))
        digests.append(m.digest())
    return digests


def _crc_table():
    # reduction table for the reference's CRC variant (data bits shifted
    # into the LOW end, poly applied on the old msb only)
    tab = []
    for v in range(256):
        c = (v << 8) & 0xFFFF
        for _ in range(8):
            msb = (c >> 15) & 1
            c = ((c << 1) & 0xFFFF) ^ (msb * 0x1021)
        tab.append(c)
    return tab


_CRC_TAB = _crc_table()


def picture_crc(planes: List[np.ndarray], bit_depth: int = 8
                ) -> List[bytes]:
    """Per-plane CRC (hash_type 1; reference TComPicYuvMD5.cpp
    compCRC:89 — init 0xffff, poly 0x1021, sample bits shifted into the
    LOW end of the register (not the crc_hqx convention), low byte of
    each sample first, 16 zero bits flushed at the end)."""
    tab = _CRC_TAB
    out = []
    for p in planes:
        if bit_depth <= 8:
            data = np.ascontiguousarray(p.astype(np.uint8)).tobytes()
        else:
            data = np.ascontiguousarray(p.astype("<u2")).tobytes()
        crc = 0xFFFF
        for b in data:
            crc = tab[crc >> 8] ^ (((crc & 0xFF) << 8) | b)
        for _ in range(2):  # flush 16 zero bits
            crc = tab[crc >> 8] ^ ((crc & 0xFF) << 8)
        out.append(bytes([(crc >> 8) & 0xFF, crc & 0xFF]))
    return out


def picture_checksum(planes: List[np.ndarray], bit_depth: int = 8
                     ) -> List[bytes]:
    """Per-plane xor-mask checksum (hash_type 2; reference
    TComPicYuvMD5.cpp compChecksum:141)."""
    out = []
    for p in planes:
        h, w = p.shape
        xs = np.arange(w, dtype=np.uint32)
        ys = np.arange(h, dtype=np.uint32)[:, None]
        mask = ((xs & 0xFF) ^ (ys & 0xFF) ^ (xs >> 8) ^ (ys >> 8)) \
            .astype(np.uint32)
        pv = p.astype(np.uint32)
        s = int(((pv & 0xFF) ^ mask).sum(dtype=np.uint64))
        if bit_depth > 8:
            s += int(((pv >> 8) ^ mask).sum(dtype=np.uint64))
        s &= 0xFFFFFFFF
        out.append(bytes([(s >> 24) & 0xFF, (s >> 16) & 0xFF,
                          (s >> 8) & 0xFF, s & 0xFF]))
    return out


def picture_hash(planes, bit_depth: int, hash_type: int) -> List[bytes]:
    if hash_type == 0:
        return picture_md5(planes, bit_depth)
    if hash_type == 1:
        return picture_crc(planes, bit_depth)
    if hash_type == 2:
        return picture_checksum(planes, bit_depth)
    raise ValueError(f"unknown decoded_picture_hash type {hash_type}")


def write_picture_hash_sei(digests: List[bytes],
                           hash_type: int = 0) -> bytes:
    """decoded_picture_hash SEI RBSP (hash_type 0 MD5 / 1 CRC /
    2 checksum)."""
    bw = BitWriter()
    per = {0: 16, 1: 2, 2: 4}[hash_type]
    payload_size = 1 + per * len(digests)
    bw.u(DECODED_PICTURE_HASH, 8)   # last_payload_type_byte
    bw.u(payload_size, 8)           # last_payload_size_byte
    bw.u(hash_type, 8)
    for d in digests:
        for b in d:
            bw.u(b, 8)
    bw.byte_align()
    return bw.bytes()


def _payload_align(p: BitWriter) -> None:
    """SEI payload alignment: bit_equal_to_one + zeros, only when the
    payload is not already byte-aligned (spec 7.3.5)."""
    if p._nbits:
        p.u(1, 1)
        p.align_zero()


def _sei_rbsp(ptype: int, payload_bits: BitWriter) -> bytes:
    """Wrap a payload in the SEI message framing (spec 7.3.5): type/size
    bytes, payload, payload alignment, rbsp trailing."""
    body = payload_bits.bytes()
    bw = BitWriter()
    t = ptype
    while t >= 255:
        bw.u(255, 8)
        t -= 255
    bw.u(t, 8)
    n = len(body)
    while n >= 255:
        bw.u(255, 8)
        n -= 255
    bw.u(n, 8)
    for b in body:
        bw.u(b, 8)
    bw.byte_align()                 # rbsp_trailing_bits (stop bit + zeros)
    return bw.bytes()


def write_active_parameter_sets_sei(vps_id: int = 0,
                                    sps_id: int = 0) -> bytes:
    """active_parameter_sets SEI (spec D.2.21 / reference
    SEIEncoder::initSEIActiveParameterSets)."""
    p = BitWriter()
    p.u(vps_id, 4)                   # active_video_parameter_set_id
    p.flag(1)                        # self_contained_cvs_flag
    p.flag(0)                        # no_parameter_set_update_flag
    p.ue(0)                          # num_sps_ids_minus1
    p.ue(sps_id)                     # active_seq_parameter_set_id[0]
    _payload_align(p)
    return _sei_rbsp(ACTIVE_PARAMETER_SETS, p)


def write_recovery_point_sei(recovery_poc_cnt: int = 0,
                             exact_match: int = 1) -> bytes:
    """recovery_point SEI (spec D.2.8)."""
    p = BitWriter()
    p.se(recovery_poc_cnt)
    p.flag(exact_match)
    p.flag(0)                        # broken_link_flag
    _payload_align(p)
    return _sei_rbsp(RECOVERY_POINT, p)


def write_user_data_sei(payload: bytes,
                        uuid: bytes = b"hevc-tpu-frmwrk!") -> bytes:
    """user_data_unregistered SEI (spec D.2.7)."""
    assert len(uuid) == 16
    p = BitWriter()
    for b in uuid + payload:
        p.u(b, 8)
    return _sei_rbsp(USER_DATA_UNREGISTERED, p)


def parse_sei_messages(rbsp: bytes):
    """Iterate (payload_type, payload_bytes) in one SEI NAL RBSP."""
    out = []
    i = 0
    while i + 1 < len(rbsp):
        t = 0
        while i < len(rbsp) and rbsp[i] == 255:
            t += 255
            i += 1
        if i >= len(rbsp):
            break
        t += rbsp[i]
        i += 1
        n = 0
        while i < len(rbsp) and rbsp[i] == 255:
            n += 255
            i += 1
        if i >= len(rbsp):
            break
        n += rbsp[i]
        i += 1
        out.append((t, rbsp[i:i + n]))
        i += n
        if i >= len(rbsp) or (len(rbsp) - i) <= 1:
            break
    return out


PIC_TIMING = 1


def write_pic_timing_sei(pic_struct: int, source_scan_type: int = 0,
                         duplicate_flag: int = 0, hrd=None,
                         cpb_removal_delay: int = 0,
                         dpb_output_delay: int = 0,
                         frame_field_info: bool = True,
                         du_data=None) -> bytes:
    """pic_timing SEI (spec D.2.3; reference
    SEIEncoder::initSEIPictureTiming): frame-field info and, when HRD
    parameters are active, the CPB removal / DPB output delays.
    `cpb_removal_delay` is the AU count since the buffering period; the
    au_cpb_removal_delay_minus1 field carries max(1, delay) - 1 clamped
    to the signalled length (reference SEIwrite.cpp:308 writes delay-1
    with delay = max(1, totalCoded - lastBP), TEncGOP.cpp:542)."""
    p = BitWriter()
    if frame_field_info:
        p.u(pic_struct, 4)
        p.u(source_scan_type, 2)
        p.flag(duplicate_flag)
    if hrd is not None:
        n = hrd.au_cpb_removal_delay_length_minus1 + 1
        p.u(min(max(1, cpb_removal_delay) - 1, (1 << n) - 1), n)
        p.u(dpb_output_delay, hrd.dpb_output_delay_length_minus1 + 1)
        if getattr(hrd, "sub_pic", 0):
            # decoding-unit timing (spec D.2.3 sub-pic branch; reference
            # TEncGOP::xCreatePictureTimingSEI DU parameters + the
            # removal-delay math in xUpdateTimingSEI). du_data is a list
            # of (num_nalus_in_du, du_cpb_removal_delay_minus1).
            factor = hrd.tick_divisor_minus2 + 2
            p.u(factor * dpb_output_delay,
                hrd.dpb_output_delay_du_length_minus1 + 1)
            if hrd.sub_pic_cpb_params_in_pic_timing_sei_flag:
                dd = du_data or [(1, 0)]
                p.ue(len(dd) - 1)    # num_decoding_units_minus1
                p.flag(0)            # du_common_cpb_removal_delay_flag
                ln = hrd.du_cpb_removal_delay_length_minus1 + 1
                for i, (nn, delay) in enumerate(dd):
                    p.ue(nn - 1)     # num_nalus_in_du_minus1
                    if i < len(dd) - 1:
                        p.u(delay, ln)
    _payload_align(p)
    return _sei_rbsp(PIC_TIMING, p)


BUFFERING_PERIOD = 0


def write_buffering_period_sei(hrd, initial_cpb_removal_delay: int,
                               initial_cpb_removal_offset: int = 0,
                               sps_id: int = 0) -> bytes:
    """buffering_period SEI (spec D.2.2; reference
    SEIEncoder::initSEIBufferingPeriod): NAL HRD, one CPB."""
    p = BitWriter()
    p.ue(sps_id)                     # bp_seq_parameter_set_id
    sub = getattr(hrd, "sub_pic", 0)
    if not sub:
        p.flag(0)                    # irap_cpb_params_present_flag
    p.flag(0)                        # concatenation_flag
    n = hrd.au_cpb_removal_delay_length_minus1 + 1
    p.u(0, n)                        # au_cpb_removal_delay_delta_minus1
    m = hrd.initial_cpb_removal_delay_length_minus1 + 1
    p.u(initial_cpb_removal_delay, m)
    p.u(initial_cpb_removal_offset, m)
    if sub:
        # alternative delays required under sub-pic HRD (spec D.3.2,
        # reference xWriteSEIBufferingPeriod SubPic||rap branch)
        p.u(initial_cpb_removal_delay, m)
        p.u(initial_cpb_removal_offset, m)
    _payload_align(p)
    return _sei_rbsp(BUFFERING_PERIOD, p)


DECODING_UNIT_INFO = 130


def write_decoding_unit_info_sei(du_idx: int, spt_delay: int, hrd) -> bytes:
    """decoding_unit_info SEI (spec D.2.22; reference
    SEIwrite.cpp xWriteSEIDecodingUnitInfo + TEncGOP DU creation:
    du_spt_cpb_removal_delay = du_cpb_removal_delay_minus1[i] + 1,
    dpb_output_du_delay not present)."""
    p = BitWriter()
    p.ue(du_idx)
    if hrd.sub_pic_cpb_params_in_pic_timing_sei_flag:
        p.u(spt_delay, hrd.du_cpb_removal_delay_length_minus1 + 1)
    p.flag(0)                        # dpb_output_du_delay_present_flag
    _payload_align(p)
    return _sei_rbsp(DECODING_UNIT_INFO, p)


# ---------------------------------------------------------------------------
# Extended SEI payload set (spec D.2/D.3; reference SEIwrite.cpp 339-790,
# TAppEncCfg.cpp:948-1060 option surface)
# ---------------------------------------------------------------------------

TONE_MAPPING_INFO = 23
FRAME_PACKING = 45
DISPLAY_ORIENTATION = 47
SOP_DESCRIPTION = 128
TEMPORAL_LEVEL0_INDEX = 131
SCALABLE_NESTING = 133
REGION_REFRESH_INFO = 134
NO_DISPLAY = 135
TIME_CODE = 136
MASTERING_DISPLAY_COLOUR_VOLUME = 137
SEGM_RECT_FRAME_PACKING = 138
CHROMA_SAMPLING_FILTER_HINT = 140
KNEE_FUNCTION_INFO = 141
TEMP_MOTION_CONSTRAINED_TILE_SETS = 139

SEI_NAMES = {
    0: "buffering_period", 1: "pic_timing", 2: "pan_scan_rect",
    3: "filler_payload", 4: "user_data_registered_itu_t_t35",
    5: "user_data_unregistered", 6: "recovery_point", 9: "scene_info",
    15: "picture_snapshot", 16: "progressive_refinement_segment_start",
    17: "progressive_refinement_segment_end",
    19: "film_grain_characteristics", 22: "post_filter_hint",
    23: "tone_mapping_info", 45: "frame_packing_arrangement",
    47: "display_orientation", 128: "structure_of_pictures_info",
    129: "active_parameter_sets", 130: "decoding_unit_info",
    131: "temporal_sub_layer_zero_index", 132: "decoded_picture_hash",
    133: "scalable_nesting", 134: "region_refresh_info",
    135: "no_display", 136: "time_code",
    137: "mastering_display_colour_volume",
    138: "segmented_rect_frame_packing_arrangement",
    139: "temporal_motion_constrained_tile_sets",
    140: "chroma_resampling_filter_hint", 141: "knee_function_info",
}


def write_tone_mapping_sei(tone_map_id=0, cancel=0, persistence=1,
                           coded_bit_depth=8, target_bit_depth=8,
                           model_id=0, min_value=0, max_value=1023,
                           sigmoid_midpoint=512, sigmoid_width=960,
                           start_of_coded_interval=(),
                           coded_pivots=(), target_pivots=(),
                           camera_iso_speed_idc=0,
                           camera_iso_speed_value=400,
                           exposure_index_idc=0, exposure_index_value=400,
                           exposure_comp_sign=0, exposure_comp_num=0,
                           exposure_comp_denom_idc=2,
                           ref_screen_luminance_white=350,
                           extended_range_white_level=800,
                           nominal_black_level=16, nominal_white_level=235,
                           extended_white_level=300) -> bytes:
    """tone_mapping_info SEI (spec D.2.15; reference
    SEIwrite.cpp:383 xWriteSEIToneMappingInfo, all five model_id forms)."""
    p = BitWriter()
    p.ue(tone_map_id)
    p.flag(cancel)
    if not cancel:
        p.flag(persistence)
        p.u(coded_bit_depth, 8)
        p.u(target_bit_depth, 8)
        p.ue(model_id)
        if model_id == 0:
            p.u(min_value, 32)
            p.u(max_value, 32)
        elif model_id == 1:
            p.u(sigmoid_midpoint, 32)
            p.u(sigmoid_width, 32)
        elif model_id == 2:
            nbits = ((coded_bit_depth + 7) >> 3) << 3
            vals = list(start_of_coded_interval)
            vals += [0] * ((1 << target_bit_depth) - len(vals))
            for v in vals[:1 << target_bit_depth]:
                p.u(v, nbits)
        elif model_id == 3:
            cb = ((coded_bit_depth + 7) >> 3) << 3
            tb = ((target_bit_depth + 7) >> 3) << 3
            p.u(len(coded_pivots), 16)
            for c, t in zip(coded_pivots, target_pivots):
                p.u(c, cb)
                p.u(t, tb)
        elif model_id == 4:
            p.u(camera_iso_speed_idc, 8)
            if camera_iso_speed_idc == 255:
                p.u(camera_iso_speed_value, 32)
            p.u(exposure_index_idc, 8)
            if exposure_index_idc == 255:
                p.u(exposure_index_value, 32)
            p.flag(exposure_comp_sign)
            p.u(exposure_comp_num, 16)
            p.u(exposure_comp_denom_idc, 16)
            p.u(ref_screen_luminance_white, 32)
            p.u(extended_range_white_level, 32)
            p.u(nominal_black_level, 16)
            p.u(nominal_white_level, 16)
            p.u(extended_white_level, 16)
        else:
            raise ValueError(f"tone map model_id {model_id} undefined")
    _payload_align(p)
    return _sei_rbsp(TONE_MAPPING_INFO, p)


def write_frame_packing_sei(arrangement_type, arrangement_id=0, cancel=0,
                            quincunx=0, content_interpretation=0,
                            persistence=1) -> bytes:
    """frame_packing_arrangement SEI (spec D.2.16;
    reference SEIwrite.cpp:339)."""
    p = BitWriter()
    p.ue(arrangement_id)
    p.flag(cancel)
    if not cancel:
        p.u(arrangement_type, 7)
        p.flag(quincunx)
        p.u(content_interpretation, 6)
        p.flag(0)                    # spatial_flipping_flag
        p.flag(0)                    # frame0_flipped_flag
        p.flag(0)                    # field_views_flag
        p.flag(0)                    # current_frame_is_frame0_flag
        p.flag(0)                    # frame0_self_contained_flag
        p.flag(0)                    # frame1_self_contained_flag
        if quincunx == 0 and arrangement_type != 5:
            for _ in range(4):       # frame0/1 grid positions x/y
                p.u(0, 4)
        p.u(0, 8)                    # frame_packing_arrangement_reserved
        p.flag(persistence)
    p.flag(0)                        # upsampled_aspect_ratio
    _payload_align(p)
    return _sei_rbsp(FRAME_PACKING, p)


def write_segmented_rect_frame_packing_sei(cancel=0,
                                           content_interpretation=0,
                                           persistence=0) -> bytes:
    """segmented_rect_frame_packing_arrangement SEI (spec D.2.16.1;
    reference SEIwrite.cpp:373)."""
    p = BitWriter()
    p.flag(cancel)
    if not cancel:
        p.u(content_interpretation, 2)
        p.flag(persistence)
    _payload_align(p)
    return _sei_rbsp(SEGM_RECT_FRAME_PACKING, p)


def write_display_orientation_sei(anticlockwise_rotation, hor_flip=0,
                                  ver_flip=0, persistence=1) -> bytes:
    """display_orientation SEI (spec D.2.17; reference
    SEIwrite.cpp:459 / SEIEncoder initSEIDisplayOrientation —
    TAppEncCfg SEIDisplayOrientation=N sets the rotation)."""
    p = BitWriter()
    p.flag(0)                        # display_orientation_cancel_flag
    p.flag(hor_flip)
    p.flag(ver_flip)
    p.u(anticlockwise_rotation, 16)
    p.flag(persistence)
    _payload_align(p)
    return _sei_rbsp(DISPLAY_ORIENTATION, p)


def write_temporal_level0_index_sei(tl0_idx, rap_idx) -> bytes:
    """temporal_sub_layer_zero_index SEI (spec D.2.22; reference
    SEIwrite.cpp:470)."""
    p = BitWriter()
    p.u(tl0_idx & 0xFF, 8)
    p.u(rap_idx & 0xFF, 8)
    _payload_align(p)
    return _sei_rbsp(TEMPORAL_LEVEL0_INDEX, p)


def write_region_refresh_sei(gdr_foreground=1) -> bytes:
    """region_refresh_info SEI (spec D.2.24; reference SEIwrite.cpp:476
    xWriteSEIGradualDecodingRefreshInfo — SEIGradualDecodingRefreshInfo
    cfg key)."""
    p = BitWriter()
    p.flag(gdr_foreground)
    _payload_align(p)
    return _sei_rbsp(REGION_REFRESH_INFO, p)


def write_no_display_sei() -> bytes:
    """no_display SEI (spec D.2.25; empty payload —
    reference SEIwrite.cpp:481)."""
    p = BitWriter()
    _payload_align(p)
    return _sei_rbsp(NO_DISPLAY, p)


def write_sop_description_sei(sps_id, entries) -> bytes:
    """structure_of_pictures_info SEI (spec D.2.26; reference
    SEIwrite.cpp:484, SEIEncoder::initSEISOPDescription built from the
    GOP RPS table). entries: [(vcl_nalu_type, temporal_id, st_rps_idx,
    poc_delta), ...] — st_rps_idx is skipped for IDR entries and
    poc_delta for the first."""
    p = BitWriter()
    p.ue(sps_id)
    p.ue(len(entries) - 1)
    for i, (nalu, tid, rps_idx, poc_delta) in enumerate(entries):
        p.u(nalu, 6)
        p.u(tid, 3)
        if nalu not in (19, 20):     # not IDR
            p.ue(rps_idx)
        if i > 0:
            p.se(poc_delta)
    _payload_align(p)
    return _sei_rbsp(SOP_DESCRIPTION, p)


def write_time_code_sei(time_sets) -> bytes:
    """time_code SEI (spec D.2.27; reference SEIwrite.cpp:602). Each
    time set is a dict with the HM TComSEITimeSet fields (defaults 0):
    ts_flag, field_based, counting_type, full_ts, discontinuity,
    cnt_dropped, n_frames, seconds/minutes/hours (+ *_flag for the
    short form), offset_len, offset."""
    p = BitWriter()
    p.u(len(time_sets), 2)
    for ts in time_sets:
        g = ts.get
        p.flag(g("ts_flag", 1))
        if g("ts_flag", 1):
            p.flag(g("field_based", 0))
            p.u(g("counting_type", 0), 5)
            full = g("full_ts", 0)
            p.flag(full)
            p.flag(g("discontinuity", 0))
            p.flag(g("cnt_dropped", 0))
            p.u(g("n_frames", 0), 9)
            if full:
                p.u(g("seconds", 0), 6)
                p.u(g("minutes", 0), 6)
                p.u(g("hours", 0), 5)
            else:
                p.flag(g("seconds_flag", 0))
                if g("seconds_flag", 0):
                    p.u(g("seconds", 0), 6)
                    p.flag(g("minutes_flag", 0))
                    if g("minutes_flag", 0):
                        p.u(g("minutes", 0), 6)
                        p.flag(g("hours_flag", 0))
                        if g("hours_flag", 0):
                            p.u(g("hours", 0), 5)
            olen = g("offset_len", 0)
            p.u(olen, 5)
            if olen > 0:
                v = g("offset", 0)
                if v < 0:            # two's complement (SEIwrite.cpp:645)
                    v = ((~v + 1) | (1 << (olen - 1))) & ((1 << olen) - 1)
                p.u(v, olen)
    _payload_align(p)
    return _sei_rbsp(TIME_CODE, p)


def write_mastering_display_sei(primaries, white_point, max_luminance,
                                min_luminance) -> bytes:
    """mastering_display_colour_volume SEI (spec D.2.28; reference
    SEIwrite.cpp:760). primaries: 3 (x, y) pairs in 1/50000 units;
    white_point: (x, y); luminances in 1/10000 cd/m2."""
    p = BitWriter()
    for (x, y) in primaries:
        p.u(x, 16)
        p.u(y, 16)
    p.u(white_point[0], 16)
    p.u(white_point[1], 16)
    p.u(max_luminance, 32)
    p.u(min_luminance, 32)
    _payload_align(p)
    return _sei_rbsp(MASTERING_DISPLAY_COLOUR_VOLUME, p)


def write_knee_function_sei(knee_id=0, cancel=0, persistence=1,
                            input_drange=1000, input_disp_luminance=100,
                            output_drange=4000, output_disp_luminance=800,
                            input_knee_points=(), output_knee_points=()) \
        -> bytes:
    """knee_function_info SEI (spec D.2.32; reference SEIwrite.cpp:739)."""
    p = BitWriter()
    p.ue(knee_id)
    p.flag(cancel)
    if not cancel:
        p.flag(persistence)
        p.u(input_drange, 32)
        p.u(input_disp_luminance, 32)
        p.u(output_drange, 32)
        p.u(output_disp_luminance, 32)
        p.ue(len(input_knee_points) - 1)
        for i, o in zip(input_knee_points, output_knee_points):
            p.u(i, 10)
            p.u(o, 10)
    _payload_align(p)
    return _sei_rbsp(KNEE_FUNCTION_INFO, p)


def write_chroma_sampling_filter_hint_sei(ver_idc=2, hor_idc=2,
                                          ver_filtering_process=1) \
        -> bytes:
    """chroma_resampling_filter_hint SEI (spec D.2.30; reference
    SEIwrite.cpp:657). idc 1 (user-defined coefficient tables) is not
    emitted — HM hardcodes a sample table; 0/2 cover the cfg surface."""
    assert ver_idc != 1 and hor_idc != 1, \
        "user-defined chroma filter coefficients not supported"
    p = BitWriter()
    p.u(ver_idc, 8)
    p.u(hor_idc, 8)
    p.flag(ver_filtering_process)
    _payload_align(p)
    return _sei_rbsp(CHROMA_SAMPLING_FILTER_HINT, p)


def write_tmcts_sei(num_tiles: int) -> bytes:
    """temporal_motion_constrained_tile_sets SEI (spec D.2.29; reference
    SEIwrite.cpp:542 xWriteSEITempMotionConstrainedTileSets, with HM's
    initSEITempMotionConstrainedTileSets shape: one tile set per tile,
    one rect per set, match/display/tier-level flags all zero)."""
    p = BitWriter()
    p.flag(0)                        # mc_all_tiles_exact_sample_value_match
    p.flag(0)                        # each_tile_one_tile_set_flag
    p.flag(0)                        # limited_tile_set_display_flag
    p.ue(num_tiles - 1)              # num_sets_in_message_minus1
    for i in range(num_tiles):
        p.ue(i)                      # mcts_id
        p.ue(0)                      # num_tile_rects_in_set_minus1
        p.ue(i)                      # top_left_tile_index
        p.ue(i)                      # bottom_right_tile_index
        p.flag(0)                    # exact_sample_value_match_flag
        p.flag(0)                    # mcts_tier_level_idc_present_flag
    _payload_align(p)
    return _sei_rbsp(TEMP_MOTION_CONSTRAINED_TILE_SETS, p)


def write_scalable_nesting_sei(nested_sei_rbsps,
                               bitstream_subset: bool = False) -> bytes:
    """scalable_nesting SEI (spec D.2.23; reference SEIwrite.cpp:504):
    wraps already-coded SEI payloads (each given as the raw payload
    stream of one SEI message, i.e. a full sei_message() without the
    NAL wrapper). bitstream_subset selects the reference encoder's
    layer-0 form used for nested buffering-period/pic-timing messages
    (SEIEncoder::initSEIScalableNesting: bitstream_subset_flag 1,
    all_layers 0, no_op_max_temporal_id_plus1 7, one layer id 0);
    the default is the all-layers form."""
    p = BitWriter()
    p.flag(1 if bitstream_subset else 0)  # bitstream_subset_flag
    p.flag(0)                        # nesting_op_flag
    if bitstream_subset:
        p.flag(0)                    # all_layers_flag
        p.u(7, 3)                    # nesting_no_op_max_temporal_id_plus1
        p.ue(0)                      # nesting_num_layers_minus1
        p.u(0, 6)                    # nesting_layer_id[0]
    else:
        p.flag(1)                    # all_layers_flag
    while p.bit_count % 8:
        p.flag(0)                    # nesting_zero_bit
    for rbsp in nested_sei_rbsps:
        # strip the rbsp_trailing byte of the nested message
        for b in rbsp[:-1] if rbsp.endswith(b"\x80") else rbsp:
            p.u(b, 8)
    _payload_align(p)
    return _sei_rbsp(SCALABLE_NESTING, p)
