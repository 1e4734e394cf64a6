"""Native-engine frame encoder: device-batched integer ME + C++ CU engine.

Counterpart of hevc_tpu/encoder/native_frame.py. Same decision flow as
intra_frame.IntraFrameEncoder._encode_cu and inter_frame.PFrameEncoder
(reference TEncCu::xCompressCU, TEncSearch::predInterSearch), but the
sequential per-CU work (prediction from reconstructed neighbours,
transforms, fractional refinement) runs in the native engine
(entropy/native/engine.cpp) while the frame-wide integer motion search runs
batched on the device (ops/me_ssd.py). The same orchestration runs on a
card and on the CPU (where the kernels' plain versions stand in), so the
CPU tests exercise what the card runs. 4:2:0 only; the pure-Python
encoders remain the reference path (HEVC_TPU_NATIVE_RECON=0) and the 4:4:4
path.
"""
from __future__ import annotations

import math
import os as _os
from typing import List, Optional

import numpy as np

from .. import runtime
from ..entropy.cabac import (EngineParamsC, NativeCtuEngine, SliceDataEncoder,
                             SliceParamsC)
from ..ops.interp import pad_plane
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
    def __init__(self, sps, qp: int, senc: SliceDataEncoder,
                 sp: SliceParamsC, *, qp_factor: float = 0.57,
                 is_b: bool = False, ref_planes=None, ref1_planes=None,
                 search_range: int = 24, cu_depth_target: int = 1,
                 me_provider=None, ref_dev=None, ref1_dev=None,
                 intra_screen=None, lam: Optional[float] = None,
                 mesh=None, mesh_axis: Optional[str] = None,
                 me_prefetch=None, ref_pocs=None, ref1_pocs=None,
                 refs_padded: bool = False, wp0=None, wp1=None,
                 device="cuda"):
        """ref_planes / ref1_planes: a single [Y, Cb, Cr] plane list or a
        list of them — one entry per active reference of the list
        (reference TEncSearch::predInterSearch per-refIdx loop,
        TEncSearch.cpp:3027). ref_dev: optional per-list-0-ref device
        arrays of the padded Y planes (encoder reference cache)."""
        assert sps.chroma_format_idc in (1, 3), \
            "native engine supports 4:2:0 and 4:4:4"
        assert sps.chroma_format_idc == 1 or ref_planes is None, \
            "native 4:4:4 is intra-only (inter 4:4:4 takes the Python path)"
        self.sps = sps
        self.qp = qp
        self.senc = senc
        self.sp = sp
        self.is_inter = ref_planes is not None
        if lam is None:  # fallback; EncoderTop passes the exact HM pic
            lam = qp_factor * (2.0 ** ((qp - 12) / 3.0))  # lambda in
        self.sqrt_lam = math.sqrt(lam)
        self.lam_fp = int(65536.0 * self.sqrt_lam)
        self.search_range = search_range
        self.cu_depth_target = cu_depth_target
        self.is_b = is_b
        # multi-device: a parallel.Mesh splits every grid's block rows
        # over its devices — the same grids, so the same stream
        self.mesh = mesh
        self.device = runtime.resolve_device(device)

        def norm(refs):
            if refs is None:
                return None
            if len(refs) and isinstance(refs[0], np.ndarray):
                refs = [refs]
            if refs_padded:  # caller passed EncoderTop._padded_ref output
                return refs
            pdt = np.int16 if sps.bit_depth_luma <= 14 else np.int32
            return [[np.ascontiguousarray(
                pad_plane(np.asarray(p, pdt), PAD)) for p in r]
                    for r in refs]

        self.ref = norm(ref_planes)
        self.ref1 = norm(ref1_planes) if ref1_planes is not None else self.ref
        self.ref_dev = ref_dev or []
        self.ref1_dev = ref1_dev or []
        # optional callable(size, range, lam_fp) -> (gx, gy) or None:
        # precomputed (mesh-sharded lookahead) integer-ME grids (ref 0)
        self.me_provider = me_provider
        # optional zero-arg resolver -> {ref cvs_poc: (gx, gy, gx2, gy2)}
        # covering BOTH lists: EncoderTop's one-frame ME lookahead — the
        # search was dispatched during the previous frame's encode and
        # has already computed under that frame's host work
        self.me_prefetch = me_prefetch
        self.ref_pocs = ref_pocs
        # per-ref luma weighted-prediction triples (w, o, denom) or None
        # per entry: the integer search then measures weighted distortion
        # (reference TComRdCostWeightPrediction weighted SAD/SSE)
        self.wp0 = wp0
        self.wp1 = wp1
        self.ref1_pocs = ref1_pocs
        # optional zero-arg resolver for an already-dispatched device
        # intra prescreen (EncoderTop's one-frame lookahead hides the
        # device round trip behind the previous frame's host work)
        self.intra_screen = intra_screen

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
            size = ctu >> self.cu_depth_target
            depth = self.sps.bit_depth_luma
            with timers.section("me_device"):
                me_x, me_y = [], []
                # the 16-grid (deeper inter quadtree) is on by default and
                # rides the same device dispatch as the CU-grid search
                want16 = (_os.environ.get("HEVC_TPU_CU16", "1") != "0"
                          and size > 16)
                n0, n1 = len(self.ref), len(self.ref1) if self.is_b else 0
                prefetched = self.me_prefetch is not None and want16
                timers.add("me_searched")
                if prefetched:
                    timers.add("me_lookahead_taken")
                if prefetched:
                    # the one-frame lookahead already dispatched this frame's
                    # whole search (both lists, both grid sizes) during the
                    # PREVIOUS frame's encode; resolving here only waits out
                    # whatever device time was not hidden under host work
                    pre = self.me_prefetch()
                    me_x = [pre[p][0] for p in self.ref_pocs]
                    me_y = [pre[p][1] for p in self.ref_pocs]
                    me16_x = [pre[p][2] for p in self.ref_pocs]
                    me16_y = [pre[p][3] for p in self.ref_pocs]
                    if any(g is None for g in me16_x):
                        me16_x = me16_y = None
                    if self.is_b:
                        me1_x = [pre[p][0] for p in self.ref1_pocs]
                        me1_y = [pre[p][1] for p in self.ref1_pocs]
                    for ri, p in enumerate(self.ref_pocs):
                        ext = pre[p][4] if len(pre[p]) > 4 else None
                        if ext:
                            rf_tables.append((0, ri, ext["off32"],
                                              ext["half32"]))
                            rf_tables.append((1, ri, ext["off16"],
                                              ext["half16"]))
                    if self.is_b:
                        for ri, p in enumerate(self.ref1_pocs):
                            ext = pre[p][4] if len(pre[p]) > 4 else None
                            if ext:
                                rf_tables.append((2, ri, ext["off32"],
                                                  ext["half32"]))
                # one upload of the source plane serves every ref's search
                orig_dev = None
                if not prefetched:
                    from ..ops.me_ssd import me_dtype
                    orig_dev = runtime.upload(orig[0].astype(me_dtype(depth)),
                                              self.device)
                all_dev = (orig_dev is not None and self.me_provider is None
                           and _os.environ.get("HEVC_TPU_ME_MULTI", "1") != "0"
                           and len(self.ref_dev) >= n0
                           and all(d is not None for d in self.ref_dev[:n0])
                           and (not self.is_b or (
                               len(self.ref1_dev) >= n1
                               and all(d is not None
                                       for d in self.ref1_dev[:n1]))))
                if all_dev:
                    # BOTH lists' references (and both grid sizes) in one
                    # launch sequence and one readback: the reference
                    # searches each refIdx of each list separately
                    # (TEncSearch.cpp:3027); here the unique reference
                    # pictures are searched once each. Duplicate POCs
                    # across L0/L1 (low-delay B) collapse to a single
                    # search.
                    from ..ops import me_ssd
                    uniq, slot, uniq_wp = [], {}, []
                    wps = ((list(self.wp0 or []) + [None] * n0)[:n0]
                           + (list(self.wp1 or []) + [None] * n1)[:n1])
                    for d, t in zip(self.ref_dev[:n0] + self.ref1_dev[:n1],
                                    wps):
                        if id(d) not in slot:
                            slot[id(d)] = len(uniq)
                            uniq.append(d)
                            uniq_wp.append(t)
                    l0s = [slot[id(d)] for d in self.ref_dev[:n0]]
                    l1s = [slot[id(d)] for d in self.ref1_dev[:n1]]
                    # default OFF — see encoder/top.py _rf(); none under a
                    # mesh, as in the reference
                    want_rf = (self.mesh is None and _os.environ.get(
                        "HEVC_TPU_ME_REFINE", "0") == "1")
                    if want16:
                        out = me_ssd.me_grids_multi2(
                            orig_dev, uniq, size, 16, self.search_range,
                            self.lam_fp, pad=PAD, depth=depth, mesh=self.mesh,
                            wp=uniq_wp, refine=want_rf)
                    else:
                        out = [(gx, gy, None, None) for gx, gy in
                               me_ssd.me_grids_multi(
                                   orig_dev, uniq, size, self.search_range,
                                   self.lam_fp, pad=PAD, depth=depth,
                                   mesh=self.mesh)]
                    me_x = [out[i][0] for i in l0s]
                    me_y = [out[i][1] for i in l0s]
                    if want16:
                        me16_x = [out[i][2] for i in l0s]
                        me16_y = [out[i][3] for i in l0s]
                        if any(g is None for g in me16_x):
                            me16_x = me16_y = None
                    if self.is_b:
                        me1_x = [out[i][0] for i in l1s]
                        me1_y = [out[i][1] for i in l1s]
                    for ri, i in enumerate(l0s):
                        ext = out[i][4] if len(out[i]) > 4 else None
                        if ext:
                            rf_tables.append((0, ri, ext["off32"],
                                              ext["half32"]))
                            rf_tables.append((1, ri, ext["off16"],
                                              ext["half16"]))
                    for ri, i in enumerate(l1s):
                        ext = out[i][4] if len(out[i]) > 4 else None
                        if ext:
                            rf_tables.append((2, ri, ext["off32"],
                                              ext["half32"]))
                elif not prefetched:
                    for r, ref in enumerate(self.ref):
                        pre = (self.me_provider(size, self.search_range,
                                                self.lam_fp)
                               if r == 0 and self.me_provider else None)
                        dev = (self.ref_dev[r] if r < len(self.ref_dev)
                               else None)
                        wpv = (self.wp0[r] if self.wp0 and r < len(self.wp0)
                               else None)
                        gx, gy = pre if pre is not None else batched_me_grid(
                            orig[0], ref[0], size, self.search_range,
                            self.lam_fp, ref_dev=dev, orig_dev=orig_dev,
                            depth=depth, wpv=wpv, device=self.device)
                        me_x.append(gx)
                        me_y.append(gy)
                    if want16:
                        me16_x, me16_y = [], []
                        for r, ref in enumerate(self.ref):
                            dev = (self.ref_dev[r]
                                   if r < len(self.ref_dev) else None)
                            wpv = (self.wp0[r]
                                   if self.wp0 and r < len(self.wp0) else None)
                            gx, gy = batched_me_grid(
                                orig[0], ref[0], 16,
                                min(self.search_range, 16), self.lam_fp,
                                ref_dev=dev, orig_dev=orig_dev, depth=depth,
                                wpv=wpv, device=self.device)
                            me16_x.append(gx)
                            me16_y.append(gy)
                        if any(g is None for g in me16_x):
                            me16_x = me16_y = None
                if (self.is_b and self.ref1 is not None and not all_dev
                        and not prefetched):
                    # list-1 integer search (B slices; reference
                    # predInterSearch list-1 loop)
                    me1_x, me1_y = [], []
                    for r, ref in enumerate(self.ref1):
                        dev = self.ref1_dev[r] if r < len(self.ref1_dev) \
                            else None
                        wpv = (self.wp1[r] if self.wp1 and r < len(self.wp1)
                               else None)
                        gx, gy = batched_me_grid(
                            orig[0], ref[0], size, self.search_range,
                            self.lam_fp, ref_dev=dev, orig_dev=orig_dev,
                            depth=depth, wpv=wpv, device=self.device)
                        me1_x.append(gx)
                        me1_y.append(gy)
        intra_hints = None
        if (self.sp.slice_type == 2 and _os.environ.get(
                "HEVC_TPU_INTRA_SCREEN", "1") != "0"):
            # device 35-mode prescreen: per-block candidate mode lists
            # for the whole frame in batched launches (all depths
            # through 16 — the screen carries int32 planes above 14
            # and its SATD accumulation stays within int32)
            with timers.section("intra_device"):
                if self.intra_screen is not None:
                    intra_hints = self.intra_screen()
                else:
                    from ..ops.intra_screen import screen_frame
                    intra_hints = screen_frame(
                        orig[0], sps.bit_depth_luma, self.sqrt_lam,
                        device=self.device)
        ep = EngineParamsC(
            pad=PAD, cu_depth_target=self.cu_depth_target,
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
