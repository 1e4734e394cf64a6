"""ctypes binding to the native entropy library (libhevc_entropy.so).

Parity: the native layer replaces the reference's TEncSbac/TEncBinCABAC and
TDecSbac/TDecBinCABAC stacks; this module is the Python-facing API used by
the encoder/decoder orchestrators. The library is rebuilt automatically when
sources are newer (single-machine dev flow; wheels would prebuild it).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
# HEVC_TPU_LIB overrides the standard library (int16 samples), e.g. with
# the TSAN build of `make tsan` for the threaded-wavefront race check
_LIB_PATH = os.environ.get(
    "HEVC_TPU_LIB", os.path.join(_NATIVE_DIR, "libhevc_entropy.so"))
# pel32=True loads the high-bit-depth build (samples as int32, 16-bit
# video): the reference's dual-build scheme (make all_highbitdepth,
# TypeDef.h:698 typedef Int Pel)
_HBD_PATH = os.path.join(_NATIVE_DIR, "libhevc_entropy_hbd.so")
_libs: dict = {}


class SliceParamsC(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in (
        "pic_w", "pic_h", "ctu_size", "qp", "slice_type",
        "max_tu_depth_intra", "max_tu_depth_inter", "chroma_format",
        "sign_hiding", "transform_skip_enabled", "min_cb_log2",
        "max_cb_log2", "min_tb_log2", "max_tb_log2", "max_merge_cand",
        "num_ref_l0", "num_ref_l1", "mvd_l1_zero")] + [
        ("ref_poc_l0", ctypes.c_int32 * 16),
        ("ref_poc_l1", ctypes.c_int32 * 16)] + [
        (n, ctypes.c_int32) for n in ("sao_luma", "sao_chroma", "bit_depth",
                                      "cur_poc", "wpp", "tile_cols",
                                      "tile_rows", "amp", "scaling_lists",
                                      "wp_on", "wp_denom")] + [
        ("wp_w", ctypes.c_int32 * 16), ("wp_o", ctypes.c_int32 * 16),
        ("wp_cdenom", ctypes.c_int32),
        ("wp_cw", ctypes.c_int32 * 32), ("wp_co", ctypes.c_int32 * 32),
        ("wp_w1", ctypes.c_int32 * 16), ("wp_o1", ctypes.c_int32 * 16),
        ("wp_cw1", ctypes.c_int32 * 32), ("wp_co1", ctypes.c_int32 * 32),
        ("cu_dqp", ctypes.c_int32),
        ("ctu_qps", ctypes.POINTER(ctypes.c_int8)),
        ("pcm", ctypes.c_int32),
        ("cabac_init", ctypes.c_int32),
        ("col_from_l0", ctypes.c_int32),
        ("slice_start_ctu", ctypes.c_int32),
        # range extensions (sps_range_extension / pps_range_extension)
        ("ts_rotation", ctypes.c_int32),
        ("ts_context", ctypes.c_int32),
        ("implicit_rdpcm", ctypes.c_int32),
        ("explicit_rdpcm", ctypes.c_int32),
        ("persistent_rice", ctypes.c_int32),
        ("bypass_align", ctypes.c_int32),
        ("ccp", ctypes.c_int32),
        ("ts_max_log2", ctypes.c_int32),
        ("dqp_depth", ctypes.c_int32),
        ("tq_bypass", ctypes.c_int32),
        ("cqp_off", ctypes.c_int32 * 2),
        # encoder-side search controls (zero-init == HM defaults on)
        ("rdoq_off", ctypes.c_int32),
        ("rdoq_ts_off", ctypes.c_int32),
        # PPS constrained_intra_pred_flag (spec 8.4.4.2.2 substitution)
        ("cip", ctypes.c_int32),
        # PPS Log2ParallelMergeLevel (absolute; 0 or 2 = off)
        ("log2_par_merge", ctypes.c_int32),
        # reference-GPU-mode ME reproduction (cfg GPUModeME) + its range
        ("gpu_mode_me", ctypes.c_int32),
        ("gpu_sr", ctypes.c_int32)]


def _build(target: str) -> None:
    """`make -j <target>` of the native library under an exclusive file
    lock: parallel test workers loading the library at once must not run
    two builds in one directory."""
    import fcntl
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-s", f"-j{os.cpu_count() or 1}", target],
                       cwd=_NATIVE_DIR, check=True)


def get_lib(pel32: bool = False) -> ctypes.CDLL:
    """The native library: the standard build (int16 samples, 8-14 bits)
    or with pel32 the high-bit-depth one (int32 samples, 15-16 bits)."""
    cached = _libs.get(pel32)
    if cached is not None:
        return cached
    # make decides what is stale; the lock keeps a reader from loading a
    # library another process is still linking. A library named by
    # HEVC_TPU_LIB is loaded as it is.
    if pel32:
        _build("hbd")
        path = _HBD_PATH
    else:
        path = _LIB_PATH
        if "HEVC_TPU_LIB" not in os.environ:
            _build("all")
    lib = ctypes.CDLL(path)
    lib.hevc_pel_bits.restype = ctypes.c_int
    assert lib.hevc_pel_bits() == (32 if pel32 else 16), path
    # sample-plane (pel) argument types for this build
    c_pel = ctypes.c_int32 if pel32 else ctypes.c_int16
    pel_np = np.ctypeslib.ndpointer(np.int32 if pel32 else np.int16,
                                    flags="C_CONTIGUOUS")
    lib.hevc_plane_sse.restype = ctypes.c_longlong
    lib.hevc_plane_sse.argtypes = [pel_np, pel_np, ctypes.c_long]
    lib.hevc_pad_plane.argtypes = [pel_np, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, pel_np]
    lib.hevc_engine_frame_stats.argtypes = [
        ctypes.POINTER(ctypes.c_longlong)]
    lib.hevc_engine_trace.argtypes = [ctypes.c_int]
    lib.hevc_engine_trace_stats.restype = ctypes.c_int
    lib.hevc_engine_trace_stats.argtypes = [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    lib.hevc_enc_create.restype = ctypes.c_void_p
    lib.hevc_enc_create.argtypes = [ctypes.POINTER(SliceParamsC)]
    lib.hevc_enc_destroy.argtypes = [ctypes.c_void_p]
    lib.hevc_enc_begin_slice.argtypes = [ctypes.c_void_p]
    i8cp = ctypes.POINTER(ctypes.c_int8)
    lib.hevc_enc_ctu_qps.restype = ctypes.c_long
    lib.hevc_enc_ctu_qps.argtypes = [ctypes.c_void_p, i8cp, i8cp]
    lib.hevc_dec_ctu_qps.restype = ctypes.c_long
    lib.hevc_dec_ctu_qps.argtypes = [ctypes.c_void_p, i8cp, i8cp]
    lib.hevc_dec_ctu_qp4.restype = ctypes.c_long
    lib.hevc_dec_ctu_qp4.argtypes = [ctypes.c_void_p, i8cp]
    lib.hevc_dec_enable_stats.argtypes = [ctypes.c_void_p]
    lib.hevc_dec_stat_bits.restype = ctypes.c_long
    lib.hevc_dec_stat_bits.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")]
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    lib.hevc_enc_ctu.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        u8p, u8p, u8p, u8p, u8p, i16p, i16p, i16p,
        u8p, u8p, u8p, u8p, u8p, i8p, i16p, i16p, i16p, i16p,
        u8p, i8p, i16p, i16p, i16p, i16p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        u8p, ctypes.c_int]
    lib.hevc_enc_publish_cu.argtypes = [
        ctypes.c_void_p] + [ctypes.c_int] * 11
    lib.hevc_enc_merge_cands.restype = ctypes.c_int
    lib.hevc_enc_merge_cands.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i16p, i8p]
    lib.hevc_enc_amvp.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, i16p]
    lib.hevc_enc_substreams.restype = ctypes.c_int
    lib.hevc_enc_substreams.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int]
    colargs = ([i16p, i16p,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")] * 2
               + [ctypes.c_int] * 3)
    lib.hevc_enc_set_col.argtypes = [ctypes.c_void_p] + colargs
    lib.hevc_dec_set_col.argtypes = [ctypes.c_void_p] + colargs
    lib.hevc_dec_set_entry.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int]
    lib.hevc_enc_get.restype = ctypes.c_long
    lib.hevc_enc_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_long]
    lib.hevc_enc_pos.restype = ctypes.c_long
    lib.hevc_enc_pos.argtypes = [ctypes.c_void_p]
    lib.hevc_enc_end_flag.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.hevc_enc_segment_cut.restype = ctypes.c_long
    lib.hevc_enc_segment_cut.argtypes = [ctypes.c_void_p]
    pelnull = ctypes.POINTER(c_pel)
    pppel = ctypes.POINTER(ctypes.POINTER(c_pel))
    pp32 = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
    lib.hevc_engine_create.restype = ctypes.c_void_p
    lib.hevc_engine_create.argtypes = (
        [ctypes.POINTER(SliceParamsC), ctypes.POINTER(EngineParamsC),
         ctypes.c_void_p] + [pelnull] * 6
        + [pppel, ctypes.c_int, pppel, ctypes.c_int]
        + [pp32, pp32, ctypes.c_int, ctypes.c_int]
        + [pp32, pp32, ctypes.c_int, ctypes.c_int]
        + [pp32, pp32])
    lib.hevc_engine_destroy.argtypes = [ctypes.c_void_p]
    lib.hevc_engine_set_intra_hints.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int]
    lib.hevc_engine_ctu.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        u8p, u8p, u8p, u8p, u8p, i16p, i16p, i16p,
        u8p, u8p, u8p, u8p, u8p, i8p, i16p, i16p, i16p, i16p,
        u8p, i8p, i16p, i16p, i16p, i16p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    stacked = [u8p, u8p, u8p, u8p, u8p, i16p, i16p, i16p,
               u8p, u8p, u8p, u8p, u8p, i8p, i16p, i16p, i16p, i16p,
               u8p, i8p, i16p, i16p, i16p, i16p,
               np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
               u8p, i8p, i8p]
    lib.hevc_engine_frame.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + stacked
    lib.hevc_enc_frame.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + stacked
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.hevc_engine_set_scaling.argtypes = [ctypes.c_void_p, i32p]
    lib.hevc_engine_set_refine.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    lib.hevc_engine_frame_order.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, i32p, i32p]
        + [ctypes.c_int] * 3 + stacked)
    lib.hevc_enc_frame_order.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, i32p, i32p]
        + [ctypes.c_int] * 3 + stacked)
    lib.hevc_enc_frame_order_budget.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, i32p, i32p]
        + [ctypes.c_int] * 3 + [ctypes.c_long] + stacked)
    lib.hevc_enc_frame_order_budget.restype = ctypes.c_long
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.hevc_enc_frame_order_tileseg.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, i32p, i32p]
        + [ctypes.c_int] * 4 + [i32p, i64p] + stacked)
    lib.hevc_enc_frame_order_tileseg.restype = ctypes.c_long
    lib.hevc_enc_frame_order_segments.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, i32p, i32p]
        + [ctypes.c_int] * 4 + [ctypes.c_long,
           np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
           np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
        + stacked)
    lib.hevc_enc_frame_order_segments.restype = ctypes.c_long
    lib.hevc_sao_estimate.argtypes = (
        [pel_np] * 6 + [ctypes.c_int] * 4 + [ctypes.c_double,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int])
    lib.hevc_sao_apply.argtypes = (
        [pel_np] * 6 + [np.ctypeslib.ndpointer(np.int32,
                                             flags="C_CONTIGUOUS")]
        + [ctypes.c_int] * 5)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.hevc_deblock_frame.argtypes = (
        [pel_np] * 3 + [ctypes.c_int] * 7    # planes, w/h/bd/cfmt/qp/offs
        + [ctypes.c_void_p]                  # qp_map (int32 or NULL)
        + [ctypes.c_int] * 8                 # qp offs, geometry, tu depths
        + [i32p, ctypes.c_int, i32p, ctypes.c_int]   # ref poc lists
        + [u8p, u8p, u8p, u8p, i16p, i8p, i16p, i16p,
           i8p, i16p, i16p])                 # stacked decision maps
    lib.hevc_dec_create.restype = ctypes.c_void_p
    lib.hevc_dec_create.argtypes = [ctypes.POINTER(SliceParamsC),
                                    ctypes.c_char_p, ctypes.c_long]
    lib.hevc_dec_destroy.argtypes = [ctypes.c_void_p]
    lib.hevc_dec_reseat.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_long]
    lib.hevc_dec_ctu.restype = ctypes.c_int
    lib.hevc_dec_ctu.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        u8p, u8p, u8p, u8p, u8p, i16p, i16p, i16p,
        u8p, u8p, u8p, u8p, u8p, i8p, i16p, i16p, i16p, i16p,
        u8p, i8p, i16p, i16p, i16p, i16p,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        u8p, i8p, i8p]
    _libs[pel32] = lib
    return lib


def make_slice_params(pic_w: int, pic_h: int, qp: int, slice_type: int = 2,
                      ctu_size: int = 64, max_tu_depth_intra: int = 3,
                      max_tu_depth_inter: int = 3, chroma_format: int = 1,
                      sign_hiding: int = 0, transform_skip: int = 0,
                      min_cb_log2: int = 3, max_tb_log2: int = 5,
                      max_merge_cand: int = 5, num_ref_l0: int = 1,
                      num_ref_l1: int = 0, mvd_l1_zero: int = 0,
                      ref_poc_l0=(), ref_poc_l1=(), sao_luma: int = 0,
                      sao_chroma: int = 0, bit_depth: int = 8,
                      cur_poc: int = 0, wpp: int = 0, tile_cols: int = 0,
                      tile_rows: int = 0, amp: int = 0,
                      scaling_lists: int = 0, cu_dqp: int = 0,
                      ctu_qps=None, pcm: int = 0,
                      cabac_init: int = 0,
                      col_from_l0: int = 1,
                      slice_start_ctu: int = 0,
                      dqp_depth: int = 0) -> SliceParamsC:
    sp = SliceParamsC(
        pic_w, pic_h, ctu_size, qp, slice_type, max_tu_depth_intra,
        max_tu_depth_inter, chroma_format, sign_hiding, transform_skip,
        min_cb_log2, (ctu_size.bit_length() - 1), 2, max_tb_log2,
        max_merge_cand, num_ref_l0, num_ref_l1, mvd_l1_zero)
    for i, pocv in enumerate(ref_poc_l0):
        sp.ref_poc_l0[i] = pocv
    for i, pocv in enumerate(ref_poc_l1):
        sp.ref_poc_l1[i] = pocv
    sp.sao_luma = sao_luma
    sp.sao_chroma = sao_chroma
    sp.bit_depth = bit_depth
    sp.cur_poc = cur_poc
    sp.wpp = wpp
    sp.tile_cols = tile_cols
    sp.tile_rows = tile_rows
    sp.amp = amp
    sp.scaling_lists = scaling_lists
    sp.cu_dqp = cu_dqp
    sp.dqp_depth = dqp_depth
    sp.pcm = pcm
    sp.cabac_init = cabac_init
    sp.col_from_l0 = col_from_l0
    sp.slice_start_ctu = slice_start_ctu
    if ctu_qps is not None:
        arr = np.ascontiguousarray(ctu_qps, dtype=np.int8)
        sp._ctu_qps_ref = arr  # keep alive
        sp.ctu_qps = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))
    return sp


class CtuDecisions:
    """Per-CTU decision maps handed to the native syntax writer."""

    def __init__(self, ctu_size: int = 64, chroma_format: int = 1):
        n4 = ctu_size // 4
        cw = ctu_size if chroma_format == 3 else ctu_size // 2
        ch = ctu_size // 2 if chroma_format == 1 else ctu_size
        self.cu_depth = np.zeros((n4, n4), np.uint8)
        self.nxn_flag = np.zeros((n4, n4), np.uint8)
        self.luma_mode = np.full((n4, n4), 1, np.uint8)
        self.chroma_mode = np.full((n4, n4), 1, np.uint8)
        self.tu_depth = np.zeros((n4, n4), np.uint8)
        self.coeff_y = np.zeros((ctu_size, ctu_size), np.int16)
        self.coeff_cb = np.zeros((ch, cw), np.int16)
        self.coeff_cr = np.zeros((ch, cw), np.int16)
        self.pred_mode = np.ones((n4, n4), np.uint8)   # 1 = intra
        self.skip_flag = np.zeros((n4, n4), np.uint8)
        self.merge_flag = np.zeros((n4, n4), np.uint8)
        self.merge_idx = np.zeros((n4, n4), np.uint8)
        self.mvp_flag = np.zeros((n4, n4), np.uint8)
        self.ref_idx = np.full((n4, n4), -1, np.int8)
        self.mvd_x = np.zeros((n4, n4), np.int16)
        self.mvd_y = np.zeros((n4, n4), np.int16)
        self.mv_x = np.zeros((n4, n4), np.int16)
        self.mv_y = np.zeros((n4, n4), np.int16)
        self.mvp_flag1 = np.zeros((n4, n4), np.uint8)
        self.ref_idx1 = np.full((n4, n4), -1, np.int8)
        self.mvd_x1 = np.zeros((n4, n4), np.int16)
        self.mvd_y1 = np.zeros((n4, n4), np.int16)
        self.mv_x1 = np.zeros((n4, n4), np.int16)
        self.mv_y1 = np.zeros((n4, n4), np.int16)
        self.sao = np.zeros(20, np.int32)
        # range extensions: RDPCM bits (0x01/0x02 Y on/dir, 0x04/0x08 Cb,
        # 0x10/0x20 Cr) and cross-component alphas at TB origins
        self.rext = np.zeros((n4, n4), np.uint8)
        self.ccp_cb = np.zeros((n4, n4), np.int8)
        self.ccp_cr = np.zeros((n4, n4), np.int8)


class EngineParamsC(ctypes.Structure):
    _fields_ = [("pad", ctypes.c_int32), ("cu_depth_target", ctypes.c_int32),
                ("strong_smoothing", ctypes.c_int32),
                ("is_b", ctypes.c_int32), ("sqrt_lam", ctypes.c_double)]


class SliceDataEncoder:
    def __init__(self, params: SliceParamsC, pel32: bool = False):
        # pel32: use the high-bit-depth build (16-bit video) so the
        # native CU engine created on top of this handle shares one
        # library instance
        self._lib = get_lib(pel32)
        self._h = self._lib.hevc_enc_create(ctypes.byref(params))

    def begin_slice(self) -> None:
        self._lib.hevc_enc_begin_slice(self._h)

    def encode_ctu(self, ctu_x: int, ctu_y: int, d: CtuDecisions,
                   end_of_slice: bool) -> None:
        self._lib.hevc_enc_ctu(
            self._h, ctu_x, ctu_y,
            np.ascontiguousarray(d.cu_depth), np.ascontiguousarray(d.nxn_flag),
            np.ascontiguousarray(d.luma_mode),
            np.ascontiguousarray(d.chroma_mode),
            np.ascontiguousarray(d.tu_depth),
            np.ascontiguousarray(d.coeff_y),
            np.ascontiguousarray(d.coeff_cb),
            np.ascontiguousarray(d.coeff_cr),
            np.ascontiguousarray(d.pred_mode),
            np.ascontiguousarray(d.skip_flag),
            np.ascontiguousarray(d.merge_flag),
            np.ascontiguousarray(d.merge_idx),
            np.ascontiguousarray(d.mvp_flag),
            np.ascontiguousarray(d.ref_idx),
            np.ascontiguousarray(d.mvd_x),
            np.ascontiguousarray(d.mvd_y),
            np.ascontiguousarray(d.mv_x),
            np.ascontiguousarray(d.mv_y),
            np.ascontiguousarray(d.mvp_flag1),
            np.ascontiguousarray(d.ref_idx1),
            np.ascontiguousarray(d.mvd_x1),
            np.ascontiguousarray(d.mvd_y1),
            np.ascontiguousarray(d.mv_x1),
            np.ascontiguousarray(d.mv_y1),
            np.ascontiguousarray(d.sao),
            np.ascontiguousarray(d.rext),
            int(end_of_slice))  # -1 defers the end_of_slice_segment_flag

    def byte_pos(self) -> int:
        """Flushed payload bytes so far (dependent-segment budgeting)."""
        return int(self._lib.hevc_enc_pos(self._h))

    def end_flag(self, flag: int) -> None:
        """Write a deferred end_of_slice_segment_flag (after
        encode_ctu(..., -1))."""
        self._lib.hevc_enc_end_flag(self._h, 1 if flag else 0)

    def segment_cut(self) -> int:
        """Close the current dependent slice segment (align + engine
        restart, contexts retained); returns the boundary byte offset."""
        return int(self._lib.hevc_enc_segment_cut(self._h))

    def publish_cu(self, x0, y0, log2, is_intra, skip=0, mv=(0, 0),
                   ref_idx=0, mv1=(0, 0), ref_idx1=-1):
        self._lib.hevc_enc_publish_cu(self._h, x0, y0, log2,
                                      1 if is_intra else 0, skip,
                                      int(mv[0]), int(mv[1]), ref_idx,
                                      int(mv1[0]), int(mv1[1]), ref_idx1)

    def merge_cands(self, x0, y0, size):
        """Returns [((l0mv, l0ref), (l1mv, l1ref)), ...] — a list entry is
        None-equivalent when its ref is -1."""
        mv = np.zeros(20, np.int16)
        ref = np.zeros(10, np.int8)
        n = self._lib.hevc_enc_merge_cands(self._h, x0, y0, size, mv, ref)
        out = []
        for i in range(n):
            out.append((((int(mv[4 * i]), int(mv[4 * i + 1])),
                         int(ref[2 * i])),
                        ((int(mv[4 * i + 2]), int(mv[4 * i + 3])),
                         int(ref[2 * i + 1]))))
        return out

    def amvp_cands(self, x0, y0, size, list_idx=0, ref=0):
        mv = np.zeros(4, np.int16)
        self._lib.hevc_enc_amvp(self._h, x0, y0, size, list_idx, ref, mv)
        return [(int(mv[0]), int(mv[1])), (int(mv[2]), int(mv[3]))]

    def get_bytes(self) -> bytes:
        n = self._lib.hevc_enc_get(self._h, None, 0)
        buf = ctypes.create_string_buffer(n)
        self._lib.hevc_enc_get(self._h, buf, n)
        return buf.raw

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hevc_enc_destroy(self._h)
            self._h = None


def scaling_blob(sld) -> np.ndarray:
    """Pack a ScalingListData into the native engine's explicit-scaling
    table: sizes {4,8,16,32} x lists [intra Y, Cb, Cr, inter Y, Cb, Cr]
    x n*n full-resolution raster coefficients (upsampled, DC applied) —
    8160 int32, mirroring CtuEngine::scaling_matrix's layout. Entries
    the file leaves unset fall back to the spec defaults, exactly as
    the Python recon resolves them."""
    from ..core import tables
    parts = []
    for size in (4, 8, 16, 32):
        for intra in (True, False):
            for c in range(3):
                m = sld.matrix(size, c, intra)
                if m is None:
                    m = tables.default_scaling_matrix(size, intra)
                if m is None:
                    m = np.full((size, size), 16, np.int32)
                parts.append(np.asarray(m, np.int32).reshape(-1))
    return np.ascontiguousarray(np.concatenate(parts), np.int32)


def _encoder_substreams(senc):
    out = np.zeros(1024, np.int32)
    n = senc._lib.hevc_enc_substreams(senc._h, out, 1024)
    return [int(x) for x in out[:n]]


# per-syntax-element bit statistic categories (must match the native
# StatCat enum; reference TComCodingStatistics element taxonomy)
SYNTAX_STAT_NAMES = [
    "split_cu_flag", "cu_skip_flag", "merge_flag", "merge_idx",
    "part_mode", "pred_mode_flag", "intra_luma_mode", "intra_chroma_mode",
    "inter_pred_idc", "ref_idx", "mvd", "mvp_idx", "transform_tree",
    "cu_qp_delta", "transform_skip_flag", "last_sig_coeff_pos",
    "sig_coeff_map", "coeff_level", "coeff_sign", "sao", "pcm_samples",
    "other",
]


class SliceDataDecoder:
    def __init__(self, params: SliceParamsC, data: bytes):
        self._lib = get_lib()
        self._data = data  # keep alive
        self._h = self._lib.hevc_dec_create(ctypes.byref(params), data,
                                            len(data))
        self._ctu = params.ctu_size
        self._cfmt = params.chroma_format

    def set_entry_points(self, offsets) -> None:
        arr = np.asarray(offsets, np.int32)
        self._lib.hevc_dec_set_entry(self._h, np.ascontiguousarray(arr),
                                     len(arr))

    def reseat(self, data: bytes) -> None:
        """Continue this decoder on a dependent slice segment's data:
        CABAC contexts, neighbour maps and the dQP chain carry over;
        only the bit reader/arithmetic engine restart (spec 9.3.1)."""
        self._data = data  # keep alive
        self._lib.hevc_dec_reseat(self._h, data, len(data))

    def enable_stats(self) -> None:
        self._lib.hevc_dec_enable_stats(self._h)

    def stat_bits(self):
        """Per-syntax-element bit counts (SYNTAX_STAT_NAMES order)."""
        out = np.zeros(len(SYNTAX_STAT_NAMES), np.uint64)
        self._lib.hevc_dec_stat_bits(self._h, out)
        return out

    def decode_ctu(self, ctu_x: int, ctu_y: int) -> tuple:
        d = CtuDecisions(self._ctu, chroma_format=self._cfmt)
        eos = self._lib.hevc_dec_ctu(
            self._h, ctu_x, ctu_y, d.cu_depth, d.nxn_flag, d.luma_mode,
            d.chroma_mode, d.tu_depth, d.coeff_y, d.coeff_cb, d.coeff_cr,
            d.pred_mode, d.skip_flag, d.merge_flag, d.merge_idx, d.mvp_flag,
            d.ref_idx, d.mvd_x, d.mvd_y, d.mv_x, d.mv_y,
            d.mvp_flag1, d.ref_idx1, d.mvd_x1, d.mvd_y1, d.mv_x1, d.mv_y1,
            d.sao, d.rext, d.ccp_cb, d.ccp_cr)
        return d, eos

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hevc_dec_destroy(self._h)
            self._h = None


def _pelptr(arr):
    """Sample-plane pointer: the array dtype (int16 default / int32
    high-bit-depth) selects the pointer type, which ctypes checks against
    the loaded build's signature."""
    if arr is None:
        return None
    ct = ctypes.c_int32 if arr.dtype == np.int32 else ctypes.c_int16
    return arr.ctypes.data_as(ctypes.POINTER(ct))


def _i32ptr(arr):
    if arr is None:
        return None
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _as_ref_list(refs):
    """Normalize a reference argument to a list of [Y, Cb, Cr] plane lists:
    accepts None, a single [3] plane list, or a list of such lists."""
    if refs is None:
        return []
    if len(refs) and isinstance(refs[0], np.ndarray):
        return [refs]
    return list(refs)


def _as_grid_list(g, n):
    """Normalize ME grids to a per-ref list of length n (None-padded)."""
    if g is None:
        return [None] * n
    if isinstance(g, np.ndarray):
        lst = [g]
    else:
        lst = list(g)
    return (lst + [None] * n)[:n]


def _plane_ptr_array(ref_list, pel32=False):
    """Flattened (pel_t*)[nref*3] ctypes array for the engine."""
    n = len(ref_list)
    ct = ctypes.c_int32 if pel32 else ctypes.c_int16
    arr = (ctypes.POINTER(ct) * max(1, n * 3))()
    for r, planes in enumerate(ref_list):
        for c in range(3):
            arr[r * 3 + c] = _pelptr(planes[c])
    return arr


def _grid_ptr_array(grids):
    arr = (ctypes.POINTER(ctypes.c_int32) * max(1, len(grids)))()
    for i, g in enumerate(grids):
        if g is not None:
            arr[i] = _i32ptr(g)
    return arr


# Zeroed rows after the engine's luma source plane. dsp::satd_rect screens a
# 12-sample side of an asymmetric (AMP) prediction unit of a 16x16 CU in
# 8x8 tiles, so it reads up to 4 samples past the unit's right and bottom
# edges (hevc_tpu's engine does the same): inside the picture those are
# neighbouring samples, but at its bottom-right corner they lie past the
# end of the plane, and without the slack they were whatever memory
# followed it, a different stream from run to run.
_SLACK_ROWS = 4


def _with_slack(plane: np.ndarray) -> np.ndarray:
    """A contiguous copy of `plane` followed by _SLACK_ROWS zeroed rows
    in the same buffer (the returned view holds it alive)."""
    h, w = plane.shape
    buf = np.zeros((h + _SLACK_ROWS, w), plane.dtype)
    buf[:h] = plane
    return buf[:h]


class NativeCtuEngine:
    """Native per-CTU mode-decision + reconstruction engine (C++ twin of
    the Python encoder loops; entropy/native/engine.cpp). ref0/ref1 accept
    a single [Y, Cb, Cr] plane list or a list of them (multi-reference,
    reference TEncSearch per-refIdx loop); me grids likewise accept one
    [ny, nx] int32 grid or a per-ref list."""

    def __init__(self, params: SliceParamsC, ep: EngineParamsC,
                 senc: SliceDataEncoder, orig, recon, ref0=None, ref1=None,
                 me_mvx=None, me_mvy=None, me16_mvx=None, me16_mvy=None,
                 me1_mvx=None, me1_mvy=None):
        pel32 = orig[0].dtype == np.int32
        self._lib = get_lib(pel32)
        orig = [_with_slack(orig[0])] + list(orig[1:])
        r0 = _as_ref_list(ref0)
        r1 = _as_ref_list(ref1)
        me_mvx = _as_grid_list(me_mvx, max(1, len(r0)))
        me_mvy = _as_grid_list(me_mvy, max(1, len(r0)))
        me16_mvx = _as_grid_list(me16_mvx, max(1, len(r0)))
        me16_mvy = _as_grid_list(me16_mvy, max(1, len(r0)))
        me1_mvx = _as_grid_list(me1_mvx, max(1, len(r1)))
        me1_mvy = _as_grid_list(me1_mvy, max(1, len(r1)))
        # keep every buffer alive for the engine lifetime
        self._keep = [params, ep, orig, recon, r0, r1, me_mvx, me_mvy,
                      me16_mvx, me16_mvy, me1_mvx, me1_mvy]
        first = next((g for g in me_mvx if g is not None), None)
        me_ny, me_nx = first.shape if first is not None else (0, 0)
        first16 = next((g for g in me16_mvx if g is not None), None)
        me16_ny, me16_nx = first16.shape if first16 is not None else (0, 0)
        r0p = _plane_ptr_array(r0, pel32)
        r1p = _plane_ptr_array(r1, pel32)
        gxp, gyp = _grid_ptr_array(me_mvx), _grid_ptr_array(me_mvy)
        g16xp, g16yp = _grid_ptr_array(me16_mvx), _grid_ptr_array(me16_mvy)
        g1xp, g1yp = _grid_ptr_array(me1_mvx), _grid_ptr_array(me1_mvy)
        self._keep += [r0p, r1p, gxp, gyp, g16xp, g16yp, g1xp, g1yp]
        self._h = self._lib.hevc_engine_create(
            ctypes.byref(params), ctypes.byref(ep), senc._h,
            _pelptr(orig[0]), _pelptr(orig[1]), _pelptr(orig[2]),
            _pelptr(recon[0]), _pelptr(recon[1]), _pelptr(recon[2]),
            r0p, len(r0), r1p, len(r1),
            gxp, gyp, me_nx, me_ny, g16xp, g16yp, me16_nx, me16_ny,
            g1xp, g1yp)
        self._ctu = params.ctu_size
        self._cfmt = params.chroma_format

    def set_refine(self, level: int, ref: int, off: np.ndarray,
                   half_min: np.ndarray) -> None:
        """Install a device fractional-refine table (ops/me_ssd
        refine_tables outputs): packed quarter offsets + 3x3-half screen minima for
        one (level, ref) — level 0/1/2 = list-0 32-grid / list-0
        16-grid / list-1 32-grid."""
        off = np.ascontiguousarray(off, np.int32)
        half_min = np.ascontiguousarray(half_min, np.int32)
        self._keep += [off, half_min]
        self._lib.hevc_engine_set_refine(
            self._h, int(level), int(ref), _i32ptr(off),
            _i32ptr(half_min))

    def set_scaling(self, blob: np.ndarray) -> None:
        """Install explicit (file-read) scaling matrices — the packed
        {4,8,16,32} x 6-list full-resolution table built by
        scaling_blob() (reference TComScalingList / TAppEncCfg
        "ScalingList"=2, TComSlice.cpp:2066)."""
        blob = np.ascontiguousarray(blob, np.int32)
        self._keep.append(blob)
        self._lib.hevc_engine_set_scaling(self._h, blob)

    def set_intra_hints(self, hints) -> None:
        """hints: {log2: (cands uint8 [ny, nx, k], costs int64 [ny, nx]
        or None)} from the device 35-mode prescreen
        (hevc_tpu_torch.ops.intra_screen)."""
        for log2, (cands, costs) in hints.items():
            cands = np.ascontiguousarray(cands, np.uint8)
            self._keep.append(cands)
            cp = None
            if costs is not None:
                costs = np.ascontiguousarray(costs, np.int64)
                self._keep.append(costs)
                cp = costs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
            ny, nx, k = cands.shape
            self._lib.hevc_engine_set_intra_hints(
                self._h, int(log2),
                cands.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), k,
                cp, ny, nx)

    def encode_ctu(self, ctu_x: int, ctu_y: int) -> CtuDecisions:
        d = CtuDecisions(self._ctu, chroma_format=self._cfmt)
        self._lib.hevc_engine_ctu(
            self._h, ctu_x, ctu_y, d.cu_depth, d.nxn_flag, d.luma_mode,
            d.chroma_mode, d.tu_depth, d.coeff_y, d.coeff_cb, d.coeff_cr,
            d.pred_mode, d.skip_flag, d.merge_flag, d.merge_idx, d.mvp_flag,
            d.ref_idx, d.mvd_x, d.mvd_y, d.mv_x, d.mv_y,
            d.mvp_flag1, d.ref_idx1, d.mvd_x1, d.mvd_y1, d.mv_x1, d.mv_y1,
            d.sao)
        return d

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hevc_engine_destroy(self._h)
            self._h = None


def sao_estimate_native(orig, deblocked, sps, bit_depth, lam,
                        slice_ids=None):
    """C++ SAO parameter estimation (engine.cpp hevc_sao_estimate);
    returns the per-CTU param list in CtuData.sao layout. slice_ids:
    per-CTU raster int32 slice indices (merge never crosses them)."""
    lib = get_lib(bit_depth > 14)
    w = sps.pic_width_in_luma_samples
    h = sps.pic_height_in_luma_samples
    ctu = sps.ctu_size
    nctu = (-(-w // ctu)) * (-(-h // ctu))
    out = np.zeros((nctu, 20), np.int32)
    dt = np.int32 if bit_depth > 14 else np.int16
    o = [np.ascontiguousarray(p, dt) for p in orig]
    dbl = [np.ascontiguousarray(p, dt) for p in deblocked]
    tc = getattr(sps, "_tile_cols", 0)
    tr = getattr(sps, "_tile_rows", 0)
    sid = None
    if slice_ids is not None:
        sid_arr = np.ascontiguousarray(slice_ids, np.int32)
        sid = sid_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.hevc_sao_estimate(o[0], o[1], o[2], dbl[0], dbl[1], dbl[2],
                          w, h, ctu, bit_depth, float(lam), out, tc, tr,
                          sid, sps.chroma_format_idc)
    return list(out)


_MAP_FIELDS = ["cu_depth", "nxn_flag", "luma_mode", "chroma_mode",
               "tu_depth", "coeff_y", "coeff_cb", "coeff_cr", "pred_mode",
               "skip_flag", "merge_flag", "merge_idx", "mvp_flag", "ref_idx",
               "mvd_x", "mvd_y", "mv_x", "mv_y", "mvp_flag1", "ref_idx1",
               "mvd_x1", "mvd_y1", "mv_x1", "mv_y1", "sao",
               "rext", "ccp_cb", "ccp_cr"]


class FrameDecisions:
    """Per-CTU decision maps for a whole frame as stacked arrays, so the
    native engine and CABAC coder process the frame in one C call each.
    view(i) exposes a CtuDecisions-compatible per-CTU window."""

    def __init__(self, nctu: int, ctu_size: int = 64, chroma_format: int = 1):
        n4 = ctu_size // 4
        cw = ctu_size if chroma_format == 3 else ctu_size // 2
        ch = ctu_size // 2 if chroma_format == 1 else ctu_size
        self.nctu = nctu
        self.ctu_size = ctu_size
        self.chroma_format = chroma_format
        self.cu_depth = np.zeros((nctu, n4, n4), np.uint8)
        self.nxn_flag = np.zeros((nctu, n4, n4), np.uint8)
        self.luma_mode = np.full((nctu, n4, n4), 1, np.uint8)
        self.chroma_mode = np.full((nctu, n4, n4), 1, np.uint8)
        self.tu_depth = np.zeros((nctu, n4, n4), np.uint8)
        self.coeff_y = np.zeros((nctu, ctu_size, ctu_size), np.int16)
        self.coeff_cb = np.zeros((nctu, ch, cw), np.int16)
        self.coeff_cr = np.zeros((nctu, ch, cw), np.int16)
        self.pred_mode = np.ones((nctu, n4, n4), np.uint8)
        self.skip_flag = np.zeros((nctu, n4, n4), np.uint8)
        self.merge_flag = np.zeros((nctu, n4, n4), np.uint8)
        self.merge_idx = np.zeros((nctu, n4, n4), np.uint8)
        self.mvp_flag = np.zeros((nctu, n4, n4), np.uint8)
        self.ref_idx = np.full((nctu, n4, n4), -1, np.int8)
        self.mvd_x = np.zeros((nctu, n4, n4), np.int16)
        self.mvd_y = np.zeros((nctu, n4, n4), np.int16)
        self.mv_x = np.zeros((nctu, n4, n4), np.int16)
        self.mv_y = np.zeros((nctu, n4, n4), np.int16)
        self.mvp_flag1 = np.zeros((nctu, n4, n4), np.uint8)
        self.ref_idx1 = np.full((nctu, n4, n4), -1, np.int8)
        self.rext = np.zeros((nctu, n4, n4), np.uint8)
        self.ccp_cb = np.zeros((nctu, n4, n4), np.int8)
        self.ccp_cr = np.zeros((nctu, n4, n4), np.int8)
        self.mvd_x1 = np.zeros((nctu, n4, n4), np.int16)
        self.mvd_y1 = np.zeros((nctu, n4, n4), np.int16)
        self.mv_x1 = np.zeros((nctu, n4, n4), np.int16)
        self.mv_y1 = np.zeros((nctu, n4, n4), np.int16)
        self.sao = np.zeros((nctu, 20), np.int32)

    def _args(self):
        return [getattr(self, f) for f in _MAP_FIELDS]

    def full_map(self, field: str, ctus_w: int, h4: int, w4: int):
        """One per-CTU map as a whole-picture (h4, w4) array (4x4 units),
        CTU tiles placed at their raster positions and edges cropped."""
        a = getattr(self, field)
        nctu, n4, _ = a.shape
        ctus_h = -(-nctu // ctus_w)
        if nctu != ctus_h * ctus_w:   # defensive: ragged decision list
            pad = np.zeros((ctus_h * ctus_w - nctu, n4, n4), a.dtype)
            a = np.concatenate([a, pad])
        return (a.reshape(ctus_h, ctus_w, n4, n4)
                 .transpose(0, 2, 1, 3)
                 .reshape(ctus_h * n4, ctus_w * n4)[:h4, :w4])

    def view(self, i: int):
        # deblock maps + qpmap + SAO walk the decisions once each; cache
        # the per-CTU views (28 attribute copies per construction)
        cache = getattr(self, "_views", None)
        if cache is None:
            cache = self._views = [None] * self.nctu
        v = cache[i]
        if v is None:
            v = _MapsView()
            for f in _MAP_FIELDS:
                setattr(v, f, getattr(self, f)[i])
            cache[i] = v
        return v

    def __len__(self):
        return self.nctu

    def __iter__(self):
        return (self.view(i) for i in range(self.nctu))

    def __getitem__(self, i):
        return self.view(i)


class _MapsView:
    __slots__ = _MAP_FIELDS


# the engine's trace totals (hevc_engine_trace_stats), in its order: the
# seconds its threads spent inside encode_ctu (busy), waiting on the CTU
# row above (wait), threads x the frame calls' wall time, and busy split
# into the RD stages; then the number of traced frame calls
ENGINE_TRACE_KEYS = ("engine_busy_s", "engine_wait_s", "engine_thread_wall_s",
                     "engine_intra_s", "engine_merge_s",
                     "engine_inter_search_s", "engine_residual_s",
                     "engine_other_s", "engine_traced_frames")


def engine_frame_stats(pel32: bool = False) -> dict:
    """Cumulative engine frame-drive telemetry across every frame call so
    far: wall vs process-CPU seconds (always counted; a wall >> cpu ratio
    means the engine thread was starved, not computing), and the trace
    totals of ENGINE_TRACE_KEYS (counted only while engine_trace is on)."""
    lib = get_lib(pel32)
    buf = (ctypes.c_longlong * 2)()
    lib.hevc_engine_frame_stats(buf)
    out = {"engine_wall_s": buf[0] / 1e9, "engine_cpu_s": buf[1] / 1e9}
    n = len(ENGINE_TRACE_KEYS)
    tot = (ctypes.c_longlong * n)()
    if lib.hevc_engine_trace_stats(tot, n) != n:
        raise RuntimeError("hevc_engine_trace_stats: unexpected layout")
    for i, k in enumerate(ENGINE_TRACE_KEYS[:-1]):
        out[k] = tot[i] / 1e9
    out[ENGINE_TRACE_KEYS[-1]] = tot[n - 1]
    return out


def engine_trace(engine: "NativeCtuEngine", on: bool) -> None:
    """Switch the engine's trace counters (stage, busy and wait times) on
    or off for the frame calls that follow, in the library the engine
    was built by."""
    engine._lib.hevc_engine_trace(1 if on else 0)


def engine_encode_frame(engine: "NativeCtuEngine", ctus_w: int, ctus_h: int,
                        fd: FrameDecisions) -> None:
    engine._lib.hevc_engine_frame(
        engine._h, ctus_w, ctus_h, fd.ctu_size, fd.chroma_format,
        *fd._args())


def entropy_encode_frame(senc: SliceDataEncoder, ctus_w: int, ctus_h: int,
                         fd: FrameDecisions) -> None:
    senc._lib.hevc_enc_frame(
        senc._h, ctus_w, ctus_h, fd.ctu_size, fd.chroma_format, *fd._args())


def pad_plane_native(plane: np.ndarray, pad: int) -> np.ndarray:
    """C++ edge-extension of a reference plane (api.cpp hevc_pad_plane);
    exact twin of ops/interp.pad_plane for the pel dtype of the matching
    native build. Falls through to the numpy pad for other dtypes."""
    pel32 = plane.dtype == np.int32
    if plane.dtype not in (np.int16, np.int32):
        from ..ops.interp import pad_plane
        return pad_plane(plane, pad)
    lib = get_lib(pel32)
    h, w = plane.shape
    out = np.empty((h + 2 * pad, w + 2 * pad), plane.dtype)
    lib.hevc_pad_plane(np.ascontiguousarray(plane), h, w, pad, out)
    return out


def sao_apply_native(deblocked, sao_params, sps, bit_depth):
    """C++ SAO application (engine.cpp hevc_sao_apply); byte-exact twin of
    hevc_tpu_torch.ops.sao.apply_sao."""
    lib = get_lib(bit_depth > 14)
    w = sps.pic_width_in_luma_samples
    h = sps.pic_height_in_luma_samples
    dt = np.int32 if bit_depth > 14 else np.int16
    dbl = [np.ascontiguousarray(p, dt) for p in deblocked]
    out = [np.empty_like(p) for p in dbl]
    prm = (np.ascontiguousarray(sao_params, np.int32)
           if isinstance(sao_params, np.ndarray)
           else np.ascontiguousarray(np.stack([np.asarray(p, np.int32)
                                               for p in sao_params])))
    lib.hevc_sao_apply(dbl[0], dbl[1], dbl[2], out[0], out[1], out[2],
                       prm, w, h, sps.ctu_size, bit_depth,
                       sps.chroma_format_idc)
    return out


def deblock_frame_native(recon, decisions, sps, qp, ref_pocs=((), ()),
                         beta_off=0, tc_off=0, qp_map=None,
                         cb_qp_offset=0, cr_qp_offset=0):
    """C++ deblocking (deblock.cpp hevc_deblock_frame); exact twin of
    ops/deblock.py build_maps + deblock_frame. Returns the filtered
    planes (in place when the inputs are already contiguous pel arrays).
    `decisions` is a FrameDecisions or a list of per-CTU map views."""
    bd = sps.bit_depth_luma
    lib = get_lib(bd > 14)
    dt = np.int32 if bd > 14 else np.int16
    planes = [np.ascontiguousarray(p, dt) for p in recon]
    w = sps.pic_width_in_luma_samples
    h = sps.pic_height_in_luma_samples

    def fld(name, want):
        if hasattr(decisions, name) and not isinstance(decisions, list):
            a = getattr(decisions, name)
        else:
            a = np.stack([getattr(d, name) for d in decisions])
        return np.ascontiguousarray(a, want)

    cu_depth = fld("cu_depth", np.uint8)
    nctu = cu_depth.shape[0]
    qm = None
    qm_ptr = None
    if qp_map is not None:
        qm = np.ascontiguousarray(qp_map, np.int32)
        qm_ptr = qm.ctypes.data_as(ctypes.c_void_p)
    r0 = np.ascontiguousarray(list(ref_pocs[0]) or [0], np.int32)
    r1 = np.ascontiguousarray(list(ref_pocs[1]) or [0], np.int32)
    lib.hevc_deblock_frame(
        planes[0], planes[1], planes[2], w, h, bd,
        sps.chroma_format_idc, qp, beta_off, tc_off, qm_ptr,
        cb_qp_offset, cr_qp_offset, sps.pic_width_in_ctus, nctu,
        sps.ctu_size, sps.log2_min_luma_coding_block_size_minus3 + 3,
        sps.max_transform_hierarchy_depth_intra,
        sps.max_transform_hierarchy_depth_inter,
        r0, len(ref_pocs[0]), r1, len(ref_pocs[1]),
        cu_depth, fld("nxn_flag", np.uint8), fld("tu_depth", np.uint8),
        fld("pred_mode", np.uint8), fld("coeff_y", np.int16),
        fld("ref_idx", np.int8), fld("mv_x", np.int16),
        fld("mv_y", np.int16), fld("ref_idx1", np.int8),
        fld("mv_x1", np.int16), fld("mv_y1", np.int16))
    return planes


COL_NONE = -(2 ** 31)   # INT32_MIN sentinel for "list unused / intra"


def set_collocated(handle_obj, mf, is_encoder: bool) -> None:
    """Attach a collocated picture's motion field (dict with mvx0/mvy0/
    refpoc0/mvx1/mvy1/refpoc1 arrays + poc) for TMVP derivation."""
    lib = handle_obj._lib
    fn = lib.hevc_enc_set_col if is_encoder else lib.hevc_dec_set_col
    rows, stride = mf["mvx0"].shape
    handle_obj._colkeep = mf   # keep arrays alive
    fn(handle_obj._h, mf["mvx0"], mf["mvy0"], mf["refpoc0"],
       mf["mvx1"], mf["mvy1"], mf["refpoc1"], stride, rows, mf["poc"])


def motion_field(decisions, sps, ref_pocs_l0, ref_pocs_l1, poc):
    """Assemble a per-4x4 motion field (ref_idx resolved to POCs) from the
    per-CTU decision maps — the reference's compressed TMVP field
    (TComMotionInfo compression; we store full 4x4 granularity and read at
    the 16x16-snapped position, which is equivalent)."""
    ctu = sps.ctu_size
    w4 = (sps.pic_width_in_luma_samples + 3) // 4
    h4 = (sps.pic_height_in_luma_samples + 3) // 4
    ctus_w = -(-sps.pic_width_in_luma_samples // ctu)

    if hasattr(decisions, "full_map"):     # encoder: stacked FrameDecisions
        def full(field):
            return decisions.full_map(field, ctus_w, h4, w4)
    else:                                  # decoder: list of per-CTU views
        def full(field):
            a = np.stack([getattr(d, field) for d in decisions])
            nctu, n4, _ = a.shape
            ctus_h = -(-nctu // ctus_w)
            return (a.reshape(ctus_h, ctus_w, n4, n4)
                     .transpose(0, 2, 1, 3)
                     .reshape(ctus_h * n4, ctus_w * n4)[:h4, :w4])
    inter = full("pred_mode") == 0
    mvx, mvy, rp = [], [], []
    for l, (fr, fx, fy, pocs) in enumerate(
            (("ref_idx", "mv_x", "mv_y", ref_pocs_l0),
             ("ref_idx1", "mv_x1", "mv_y1", ref_pocs_l1))):
        ridx = full(fr)
        use = inter & (ridx >= 0)
        mvx.append(np.where(use, full(fx), np.int16(0)))
        mvy.append(np.where(use, full(fy), np.int16(0)))
        r = np.full((h4, w4), COL_NONE, np.int32)
        if len(pocs):
            pl = np.asarray(pocs, np.int32)
            idxs = np.clip(ridx.astype(np.int32), 0, len(pl) - 1)
            np.copyto(r, pl[idxs], where=use)
        rp.append(r)
    return {"mvx0": mvx[0], "mvy0": mvy[0], "refpoc0": rp[0],
            "mvx1": mvx[1], "mvy1": mvy[1], "refpoc1": rp[1], "poc": poc}


def tile_scan_order(pic_w, pic_h, ctu, tile_cols, tile_rows):
    """CTU (cx, cy) processing order for a uniform tile grid (spec 6.5.1);
    raster when no tiles."""
    cw = -(-pic_w // ctu)
    ch = -(-pic_h // ctu)
    if tile_cols <= 1 and tile_rows <= 1:
        return [(x, y) for y in range(ch) for x in range(cw)]
    def edges(n, t):
        return [i * n // t for i in range(t)] + [n]
    xs = edges(cw, max(tile_cols, 1))
    ys = edges(ch, max(tile_rows, 1))
    order = []
    for r in range(len(ys) - 1):
        for c in range(len(xs) - 1):
            for y in range(ys[r], ys[r + 1]):
                for x in range(xs[c], xs[c + 1]):
                    order.append((x, y))
    return order


def engine_encode_frame_order(engine, order, ctus_w, fd):
    cxs = np.ascontiguousarray([c[0] for c in order], np.int32)
    cys = np.ascontiguousarray([c[1] for c in order], np.int32)
    engine._lib.hevc_engine_frame_order(
        engine._h, len(order), cxs, cys, ctus_w, fd.ctu_size,
        fd.chroma_format, *fd._args())


def entropy_encode_frame_order(senc, order, ctus_w, fd):
    cxs = np.ascontiguousarray([c[0] for c in order], np.int32)
    cys = np.ascontiguousarray([c[1] for c in order], np.int32)
    senc._lib.hevc_enc_frame_order(
        senc._h, len(order), cxs, cys, ctus_w, fd.ctu_size,
        fd.chroma_format, *fd._args())


def entropy_encode_frame_order_segments(senc, order, ctus_w, fd,
                                        seg_mode, seg_arg):
    """Dependent slice segments: encode `order` as one slice cut into
    segments (mode 1: seg_arg CTUs, mode 2: seg_arg bytes). Returns
    (ctus_per_segment, byte_marks) — byte_marks[i] is the payload offset
    where segment i ends (-1 marks the final segment, which ends at
    get_bytes())."""
    cxs = np.ascontiguousarray([c[0] for c in order], np.int32)
    cys = np.ascontiguousarray([c[1] for c in order], np.int32)
    seg_ctus = np.zeros(len(order) + 1, np.int32)
    seg_marks = np.zeros(len(order) + 1, np.int64)
    n = int(senc._lib.hevc_enc_frame_order_segments(
        senc._h, len(order), cxs, cys, ctus_w, fd.ctu_size,
        fd.chroma_format, seg_mode, seg_arg, seg_ctus, seg_marks,
        *fd._args()))
    return [int(x) for x in seg_ctus[:n]], [int(x) for x in seg_marks[:n]]


def entropy_encode_frame_order_tilesegs(senc, order, ctus_w, fd, bounds):
    """SliceSegmentMode 3 (tile-aligned dependent segments): encode
    `order` (tile scan) as one slice cut at the cumulative CTU counts in
    `bounds` — each a tile-group end (reference
    TEncSlice::xDetermineStartAndBoundingCtuTsAddr,
    FIXED_NUMBER_OF_TILES). Returns byte_marks (payload offset where
    each segment ends; -1 marks the final segment)."""
    cxs = np.ascontiguousarray([c[0] for c in order], np.int32)
    cys = np.ascontiguousarray([c[1] for c in order], np.int32)
    ba = np.ascontiguousarray(bounds, np.int32)
    marks = np.zeros(len(bounds) + 1, np.int64)
    n = int(senc._lib.hevc_enc_frame_order_tileseg(
        senc._h, len(order), cxs, cys, ctus_w, fd.ctu_size,
        fd.chroma_format, len(ba), ba, marks, *fd._args()))
    return [int(x) for x in marks[:n]]


def entropy_encode_frame_order_budget(senc, order, ctus_w, fd,
                                      byte_budget):
    """SliceMode 2: code `order` until the flushed slice payload reaches
    byte_budget — the crossing CTU is included, as in the reference slice
    byte-limit termination (TEncSlice::compressSlice). Returns the number
    of CTUs coded."""
    cxs = np.ascontiguousarray([c[0] for c in order], np.int32)
    cys = np.ascontiguousarray([c[1] for c in order], np.int32)
    return int(senc._lib.hevc_enc_frame_order_budget(
        senc._h, len(order), cxs, cys, ctus_w, fd.ctu_size,
        fd.chroma_format, byte_budget, *fd._args()))


def fetch_ctu_qps(obj, n_ctus: int, decoder: bool = False):
    """Per-CTU (predicted, final) luma QPs recorded by the native slice
    codec during the last frame (cu_qp_delta; spec 8.6.1). Returns None
    when cu_qp_delta was not enabled."""
    pred = np.zeros(n_ctus, np.int8)
    fin = np.zeros(n_ctus, np.int8)
    fn = obj._lib.hevc_dec_ctu_qps if decoder else obj._lib.hevc_enc_ctu_qps
    cnt = fn(obj._h,
             pred.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
             fin.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    if cnt == 0:
        return None
    return pred, fin


def fetch_ctu_qp4(sdec, ctu_size: int):
    """Per-4x4 luma QP map of the CTU just decoded ((ctu/4, ctu/4) int8;
    spec 8.6.1 QpY per quantization group). None if dqp was off."""
    n4 = ctu_size // 4
    out = np.zeros((n4, n4), np.int8)
    cnt = sdec._lib.hevc_dec_ctu_qp4(
        sdec._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    if cnt == 0:
        return None
    return out
