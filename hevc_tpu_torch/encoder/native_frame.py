"""Native-engine frame encoder: device-batched integer ME + C++ CU engine.

Counterpart of hevc_tpu/encoder/native_frame.py. Same decision flow as
intra_frame.IntraFrameEncoder._encode_cu and inter_frame.PFrameEncoder
(reference TEncCu::xCompressCU, TEncSearch::predInterSearch), but the
sequential per-CU work (prediction from reconstructed neighbours,
transforms, fractional refinement) runs in the native engine
(entropy/native/engine.cpp) while the frame-wide integer motion search runs
batched on the device (ops/me_ssd.py). The same orchestration runs on a
card and on the CPU (where the kernels' plain versions stand in), so the
CPU tests exercise what the card runs. 4:2:0, and 4:4:4 all-intra; the
pure-Python encoders take lossless, 4:2:2 and 4:4:4 inter. EncoderTop owns
the device work: it hands this encoder each picture's search and intra
prescreen as resolvers.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from .. import runtime
from ..entropy.cabac import (EngineParamsC, NativeCtuEngine, SliceDataEncoder,
                             SliceParamsC)
from ..utils.timing import timers

PAD = 80


def wp_apply_np(plane: np.ndarray, wpv, depth: int) -> np.ndarray:
    """Host twin of ops/me_ssd.wp_apply: the integer-pel weighted-prediction
    transform of a reference plane (w, o, denom)."""
    w, o, d = int(wpv[0]), int(wpv[1]), int(wpv[2])
    s = plane.astype(np.int64)
    v = ((s * w + ((1 << (d - 1)) if d > 0 else 0)) >> d) \
        + (o << max(depth - 8, 0))
    return np.clip(v, 0, (1 << depth) - 1).astype(plane.dtype)


def batched_me_grid(orig_y: np.ndarray, ref_padded_y: np.ndarray, size: int,
                    search_range: int, lam_fp: int, ref_dev=None,
                    orig_dev=None, depth: int = None, wpv=None,
                    device="cuda"):
    """Frame-batched integer full search for every aligned size x size
    block; returns (mv_x, mv_y) int32 grids [ny, nx].

    Runs the device SSD search (ops/me_ssd.py). ref_dev, when given, is
    the padded reference Y plane already resident on the device (the
    encoder's reference cache: each upload is paid once). wpv, when given,
    is the (w, o, denom) triple the device applies to the reference before
    the search (me_ssd.wp_apply, into a new plane)."""
    h, w = orig_y.shape
    nx = (w - size) // size + 1 if w >= size else 0
    ny = (h - size) // size + 1 if h >= size else 0
    if ny == 0 or nx == 0:
        return None, None
    if depth is None:
        mx = max(int(orig_y.max(initial=0)),
                 int(ref_padded_y.max(initial=0)))
        depth = 8 if mx < 256 else (10 if mx < 1024 else 12)
    from ..ops import me_ssd
    dev = runtime.resolve_device(device)
    dt = me_ssd.me_dtype(depth)
    ref = ref_dev if ref_dev is not None else \
        runtime.upload(ref_padded_y.astype(dt), dev)
    src = orig_dev if orig_dev is not None else \
        runtime.upload(orig_y.astype(dt), dev)
    if wpv is not None:
        ref = me_ssd.wp_apply(ref, wpv, depth)
    return me_ssd.me_grid_ssd(src, ref, size, search_range, lam_fp, pad=PAD,
                              depth=depth)


class NativeFrameEncoder:
    def __init__(self, sps, senc: SliceDataEncoder, sp: SliceParamsC, *,
                 lam: float, is_b: bool = False, ref_planes=None,
                 ref1_planes=None, grids=None, intra_hints=None):
        """ref_planes / ref1_planes: per active reference of each list
        (reference TEncSearch::predInterSearch per-refIdx loop,
        TEncSearch.cpp:3027), its [Y, Cb, Cr] planes padded by PAD
        (EncoderTop._padded_ref). The encoder searches nothing itself:
        `grids` (inter pictures) is EncoderTop's zero-arg resolver of the
        picture's integer motion search, (l0, l1) with one
        (gx, gy, gx2, gy2[, refine tables]) per reference of each list, and
        `intra_hints` (I pictures) its resolver of the device intra
        prescreen."""
        assert sps.chroma_format_idc in (1, 3), \
            "native engine supports 4:2:0 and 4:4:4"
        assert sps.chroma_format_idc == 1 or ref_planes is None, \
            "native 4:4:4 is intra-only (inter 4:4:4 takes the Python path)"
        self.sps = sps
        self.senc = senc
        self.sp = sp
        self.is_inter = ref_planes is not None
        self.sqrt_lam = math.sqrt(lam)
        self.is_b = is_b
        self.ref = ref_planes
        self.ref1 = ref1_planes if ref1_planes is not None else ref_planes
        self.grids = grids
        self.intra_hints = intra_hints

    def encode_frame(self, orig: List[np.ndarray], slices=None):
        """slices: optional [(sp_i, senc_i, [(cx, cy), ...]), ...] for
        multi-slice pictures (SliceMode 1/3)."""
        sps = self.sps
        w = sps.pic_width_in_luma_samples
        h = sps.pic_height_in_luma_samples
        ctu = sps.ctu_size
        cfmt = sps.chroma_format_idc
        csx = 0 if cfmt == 3 else 1
        # sample dtype: int16 through 14-bit internal depth, int32 for
        # 16-bit (high-bit-depth build; reference TypeDef.h:698)
        pdt = np.int16 if sps.bit_depth_luma <= 14 else np.int32
        orig = [np.ascontiguousarray(p, pdt) for p in orig]
        recon = [np.zeros((h, w), pdt),
                 np.zeros((h >> csx, w >> csx), pdt),
                 np.zeros((h >> csx, w >> csx), pdt)]
        me_x = me_y = me16_x = me16_y = me1_x = me1_y = None
        rf_tables = []  # device fractional-refine tables
        if self.is_inter:
            with timers.section("me_device"):
                l0, l1 = self.grids()
            l1 = l1 if self.is_b else []
            me_x, me_y, me16_x, me16_y = ([g[k] for g in l0] for k in range(4))
            if any(g is None for g in me16_x):
                me16_x = me16_y = None
            if self.is_b:
                me1_x, me1_y = ([g[k] for g in l1] for k in range(2))
            # refine levels: 0 and 1 are list 0's CU and 16 grids, 2 is
            # list 1's CU grid
            for lvl, grids, key in ((0, l0, "32"), (1, l0, "16"),
                                    (2, l1, "32")):
                for ri, g in enumerate(grids):
                    if len(g) > 4 and g[4]:
                        rf_tables.append((lvl, ri, g[4]["off" + key],
                                          g[4]["half" + key]))
        intra_hints = None
        if self.intra_hints is not None:
            with timers.section("intra_device"):
                intra_hints = self.intra_hints()
        # the search's CU grid is ctu >> 1 (EncoderTop._dispatch_search)
        ep = EngineParamsC(
            pad=PAD, cu_depth_target=1,
            strong_smoothing=sps.strong_intra_smoothing_enabled_flag,
            is_b=1 if self.is_b else 0, sqrt_lam=self.sqrt_lam)
        from ..entropy.cabac import (FrameDecisions, engine_encode_frame,
                                     engine_encode_frame_order, engine_trace,
                                     scaling_blob, tile_scan_order)
        sblob = (scaling_blob(sps.scaling_list_data)
                 if (sps.scaling_list_enabled_flag
                     and sps.scaling_list_data is not None) else None)
        ctus_w, ctus_h = -(-w // ctu), -(-h // ctu)
        fd = FrameDecisions(ctus_w * ctus_h, ctu, cfmt)
        if slices is not None:
            # multi-slice picture (reference TEncSlice slice modes): one
            # engine + entropy state per slice segment, shared recon and
            # device ME grids; prediction availability stops at each
            # slice start via sp.slice_start_ctu
            with timers.section("engine_host"):
                for sp_i, senc_i, ctus in slices:
                    eng = NativeCtuEngine(
                        sp_i, ep, senc_i, orig, recon, self.ref,
                        self.ref1 if self.is_b else self.ref,
                        me_x, me_y, me16_x, me16_y, me1_x, me1_y)
                    for lvl, ri, off, half in rf_tables:
                        eng.set_refine(lvl, ri, off, half)
                    if intra_hints:
                        eng.set_intra_hints(intra_hints)
                    if sblob is not None:
                        eng.set_scaling(sblob)
                    engine_trace(eng, timers.enabled)
                    engine_encode_frame_order(eng, ctus, ctus_w, fd)
            return fd, recon
        eng = NativeCtuEngine(self.sp, ep, self.senc, orig, recon,
                              self.ref, self.ref1 if self.is_b else self.ref,
                              me_x, me_y, me16_x, me16_y, me1_x, me1_y)
        for lvl, ri, off, half in rf_tables:
            eng.set_refine(lvl, ri, off, half)
        if intra_hints:
            eng.set_intra_hints(intra_hints)
        if sblob is not None:
            eng.set_scaling(sblob)
        engine_trace(eng, timers.enabled)
        with timers.section("engine_host"):
            if self.sp.tile_cols > 1 or self.sp.tile_rows > 1:
                order = tile_scan_order(w, h, ctu, self.sp.tile_cols,
                                        self.sp.tile_rows)
                engine_encode_frame_order(eng, order, ctus_w, fd)
            else:
                engine_encode_frame(eng, ctus_w, ctus_h, fd)
        return fd, recon
