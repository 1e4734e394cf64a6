"""Smoke run of hevc_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py [--seed N]

Phases, each printed on its own line with its seconds:
  1. build the CUDA kernel libraries (nvcc, from hevc_tpu_torch/csrc) and
     the native entropy/CU-engine library (make); count the VABSDIFF4
     instructions of each SAD kernel (the fused full search among them) in
     cuobjdump's SASS;
  2. hold every kernel against its plain PyTorch version on the card, at
     the shapes the encoder gives it at 1920x1080 (exact integer
     equality), and time kernel, plain version and library yardstick;
     the SAD entries that no encoder path calls (sad_table, cost_argmin,
     sad_table_from_planes, me_from_planes) run here through their entry
     points with the launch counters reset just before; the fused full
     search of the fallback path is held to its plain version on all four
     outputs with per-block predictors; the SAD kernels also on 10-bit
     samples (the 8-bit inputs << 2); the 8-bit bound divides by the
     published VABSDIFF4 rate, and a probe of it is printed beside, as is
     a probe of the int8 mma.sync rate the deep SSD kernel runs on;
  3. encode 1920x1080 8-bit low-delay P through the CLI entry point on
     the card, with the launch counters reset just before it: 13 frames,
     the IDR and twelve P frames, so that the GOP's reference deltas
     (-1 -5 -9 -13 ...) bring the reference count from 1 up to 4;
 3b. encode the same LDP clip with the fractional-refine tables
     (HEVC_TPU_ME_REFINE=1) and without, twice each in turns, with the
     lookahead on the final references (HEVC_TPU_ME_PREFILTER_REF=0): one
     md5 for all four; then with the tables and the default pre-loop-filter
     lookahead; engine_host, me_device and frames/s of each, and the
     refine_tables launches;
 3c. encode a 1920x1080 fade (the luma of picture t scaled by 1 - 0.08 t,
     6 frames) with WeightedPredP=1: the analysis must choose weights, so
     wp_apply launches;
  4. encode 416x240 (13 frames) on the card and on the CPU: the streams
     must match;
  5. encode 416x240 4:2:2 (the fallback inter path, one launch of the
     fused full-search kernel a P picture) on the card and on the CPU, at
     8 and at 10 bits: each pair of streams must match; then 1920x1080
     8-bit 4:2:2, the IDR and one P picture, on the card under
     torch.profiler: its wall time, the full search's device time and its
     launches;
  6. encode 1920x1080 8-bit all-intra (HM's encoder_intra_main settings)
     through the CLI entry point on the card, with the launch counters
     reset just before it: every picture runs the intra prescreen kernel;
  7. encode 416x240 all-intra on the card and on the CPU: the streams must
     match, which holds the prescreen kernel to its plain version inside
     the encoder;
 7b. encode 1920x1080 random access (HM's encoder_randomaccess_main settings,
     the IDR and one hierarchical-B GOP of 8, 9 frames) through the CLI
     entry point on the card at 8 bits and, with the Main10 cfg, at 10 bits,
     the launch counters reset just before each: the deep search kernels
     (ssd_table_deep, box_energies_deep) run at 10 bits and not at 8;
 7c. encode 416x240 RA-Main10 and low-delay B (9 frames each) on the card
     and on the CPU: each pair of streams must match;
 7d. encode 416x240 with weighted prediction (an LDP fade with
     WeightedPredP=1, an RA-Main10 fade with WeightedPredB=1) and with the
     refine tables (LDP, the default lookahead) on the card and on the CPU:
     each pair of streams must match;
  8. decode every stream of phases 3-7d with the port's own decoder: every
     picture's MD5 SEI must check and the picture counts must match;
  9. encode 4 LDP (without and with the refine tables), 2 all-intra and 9
     RA-Main10 1080p frames under
     torch.profiler: the device time of every kernel and the device's busy
     share of each encode's wall time (phases 3, 6 and 7b keep their
     unprofiled frames/s);
 10. report the card.
Phase 2 also holds the intra prescreen kernel to its plain version on
1080p planes (8-bit, 10-bit, and one with flat regions where many modes
tie), holds the deep SSD table and deep window energies to theirs on the
1080p planes at 10 and 12 bits (and a 10-bit plane with flat regions), and
times the reference padding (one F.pad(mode="replicate")) beside the index
gathers it replaced, on uint8 and int16 planes; and holds wp_apply and
refine_tables (csrc/me_refine.cu) to theirs at 8 and 10 bits, the refine
tables at the MVs the search finds and at MVs on the window's edges, times
wp_apply_multi at 1, 2 and 4 planes a launch beside a device copy of the
same bytes, and each refine grid with its half stage alone (a probe entry
that no encoder path calls).
The input is synthetic moving texture made from --seed with numpy.
The last two lines are a JSON object with every kernel's numbers and the
result {"ok": true, "device": {...}}. Any failed phase exits non-zero.
"""
import argparse
import contextlib
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
LDP_CFG = os.path.join(HERE, "hevc_tpu_torch", "cfg",
                       "encoder_lowdelay_P_main.cfg")
INTRA_CFG = os.path.join(HERE, "hevc_tpu_torch", "cfg",
                         "encoder_intra_main.cfg")
RA_CFG = os.path.join(HERE, "hevc_tpu_torch", "cfg",
                      "encoder_randomaccess_main.cfg")
RA10_CFG = os.path.join(HERE, "hevc_tpu_torch", "cfg",
                        "encoder_randomaccess_main10.cfg")
LDB_CFG = os.path.join(HERE, "hevc_tpu_torch", "cfg",
                       "encoder_lowdelay_main.cfg")
# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8
# tensor-core ops/s, and 32-bit scalar (non-tensor-core) ops/s
HBM_BPS = 3.35e12
INT8_TC_OPS = 1979e12
SCALAR32_OPS = 67e12
# VABSDIFF4 (PTX vabsdiff4) instructions a clock on one SM of compute
# capability 9.0, from the CUDA C++ Programming Guide's table of arithmetic
# instruction throughput; times the SM count and the card's maximum SM clock
VABSDIFF4_PER_CLK_SM = 64
PAD = 80
# frames of the LDP encodes: POC 10 is the first picture whose four
# reference deltas all land on coded pictures
N_FRAMES = 13
# frames of the all-intra encodes
N_INTRA = 5
# frames of the random-access and low-delay B encodes: the IDR and one GOP
# of eight
N_RA = 9
# frames of the 1080p weighted-prediction fade (WeightedPredP=1) and its
# gain ramp: the luma of picture t is scaled by 1 - FADE * t
N_FADE = 6
FADE = 0.08
# md5 of the 1080p streams for --seed 1, as recorded in PERF.md: low-delay
# P, and all-intra
HD_MD5_SEED1 = "3c38a4a0a2472e9637789e622fb401e7"
HD_INTRA_MD5_SEED1 = "825b596a8ee1b95f8cc1340e97ffb230"
# md5 of the 1080p random-access streams (9 frames) for --seed 1: Main
# (8-bit) and Main10
HD_RA_MD5_SEED1 = "0d2387822770024889ce918ccb870e8c"
HD_RA10_MD5_SEED1 = "76a44119fc94b6ae0e1bf499df94b4e8"


def log(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"[phase {self.name}] start")
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"[phase {self.name}] ok "
                f"{time.perf_counter() - self.t0:.2f} s")
        return False


# ---------------------------------------------------------------- content
def _box(a, k):
    """k x k box blur (edge-padded), separable, via cumulative sums."""
    p = k // 2
    a = np.pad(a, p, mode="edge")
    c = np.concatenate([np.zeros((1, a.shape[1])), a.cumsum(0)])
    a = (c[k:] - c[:-k]) / k
    c = np.concatenate([np.zeros((a.shape[0], 1)), a.cumsum(1)], axis=1)
    return (c[:, k:] - c[:, :-k]) / k


def _texture(rng, h, w):
    t = _box(_box(rng.random((h, w)) * 255.0, 9), 5)
    t = (t - t.mean()) * 6.0 + 128.0 + rng.normal(0.0, 3.0, (h, w))
    return np.clip(t, 0, 255).astype(np.uint8)


def clip_frames(w, h, n, seed, chroma=420):
    """n frames [Y, Cb, Cr] (uint8) of textured background panning by
    (2, 3) per frame with a textured square moving the other way."""
    rng = np.random.default_rng(seed)
    bg = _texture(rng, h + 2 * n + 8, w + 3 * n + 8)
    s = max(16, min(h, w) // 4)
    fg = _texture(rng, s, s)
    frames = []
    for t in range(n):
        y = bg[2 * t:2 * t + h, 3 * t:3 * t + w].copy()
        oy = (h // 3 + 3 * t) % (h - s)
        ox = (w - s - 1 - 5 * t) % (w - s)
        y[oy:oy + s, ox:ox + s] = fg
        if chroma == 420:
            u, v = y[::2, ::2], y[1::2, ::2]
        else:
            u, v = y[:, ::2], y[:, 1::2]
        frames.append([y, (u // 2 + 40).astype(np.uint8),
                       (v // 3 + 70).astype(np.uint8)])
    return frames


def deep_plane(p, bit_depth):
    """A uint8 plane at bit_depth > 8, int16: each sample s becomes
    s << k | s & (2^k - 1), k = bit_depth - 8."""
    k = bit_depth - 8
    return ((p.astype(np.int16) << k) | (p & ((1 << k) - 1))).astype(np.int16)


def write_clip(path, w, h, n, seed, chroma=420, bit_depth=8, fade=0.0):
    """Write clip_frames(...) as planar YUV; returns the (8-bit) luma
    planes. Above 8 bits the samples are deep_plane's, written as 16-bit
    little-endian. fade > 0 scales the luma of picture t by 1 - fade * t
    (a fade to black, for weighted prediction)."""
    frames = clip_frames(w, h, n, seed, chroma)
    for t, planes in enumerate(frames):
        if fade:
            planes[0] = np.rint(planes[0] * (1.0 - fade * t)).astype(
                np.uint8)
    with open(path, "wb") as fh:
        for planes in frames:
            for p in planes:
                if bit_depth > 8:
                    p = deep_plane(p, bit_depth).astype("<u2")
                fh.write(p.tobytes())
    return [f[0] for f in frames]


# ---------------------------------------------------------------- timing
def cuda_ms(fn, reps, queued=False):
    """Milliseconds per call of fn between two CUDA events, a mean over reps
    calls after one warm-up call. By default the host issues the calls as
    it goes, so a call that is shorter on the device than its host launch
    cost is timed at that cost (the method of the first slice, which the
    "ms" of the kernels line keeps). With queued=True a device-side sleep
    (about 0.1 ms a call) runs first, the calls queue behind it and run
    back to back: device time alone, without the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000 * reps)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def check_sass():
    """The 8-bit SAD sweep's packed instruction as compiled: count the
    VABSDIFF4 (and scalar VABSDIFF) instructions of each sad.cu kernel in
    cuobjdump's SASS. Fails when cuobjdump is missing or a table kernel
    has none."""
    from hevc_tpu_torch import runtime
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        raise AssertionError("cuobjdump not found: the SASS of libsad.so "
                             "cannot be checked")
    sass = subprocess.run([tool, "-sass", os.path.join(
        runtime.BUILD_DIR, "libsad.so")], capture_output=True, text=True,
        timeout=120, check=True).stdout
    for part in sass.split("Function : ")[1:]:
        fname = part.split(None, 1)[0]
        short = next((k for k in ("sad_table_kernel", "sad_planes_kernel",
                                  "me_planes_kernel", "full_search_kernel",
                                  "probe")
                      if k in fname), None)
        if short is None:
            continue
        ops = part.count("VABSDIFF4")
        log(f"    {short} ({fname[:60]}): {ops} VABSDIFF4, "
            f"{part.count('VABSDIFF.')} VABSDIFF, {part.count('FADD')} FADD, "
            f"{part.count(' SHF.')} SHF, {part.count(' LDS')} LDS")
        if ops == 0:
            raise AssertionError(f"{fname}: no VABSDIFF4 in its SASS")


def bound_ms(nbytes, ops, op_rate):
    tb, to = nbytes / HBM_BPS * 1e3, ops / op_rate * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def max_abs_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


# ---------------------------------------------------------------- phases
def check_kernels(frames, seed, results):
    """Phase 2: kernels against their plain versions at 1080p shapes."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.encoder.top import hm_pic_lambda
    from hevc_tpu_torch.ops import me_ssd
    dev = torch.device("cuda")
    h, w = frames[0].shape
    orig = torch.from_numpy(frames[1]).to(dev)
    refp = me_ssd.pad_ref_device(torch.from_numpy(frames[0]).to(dev), PAD)
    lam = hm_pic_lambda(35, 4, 1, 0.4624, False)  # first P frame, QP 32+3
    lam_fp = int(65536.0 * lam ** 0.5)
    lam_q8 = me_ssd.lam_q8_of(lam_fp)

    # --- window energies, SSD table and two-pass argmin, both grids of the
    # main path (the ssd_table wrapper launches box_energies, then its own
    # kernel; its "ms" is the wrapper's, as in the first slice). "ms" is
    # timed as the first slice timed it, "q_ms" queued behind a sleep.
    names = ("ssd_table", "argmin_two_pass", "box_energies")
    acc = {k: {"ms": 0.0, "q_ms": 0.0, "plain_ms": 0.0, "bytes_b": 0.0,
               "ops_b": 0.0, "err": 0, "lib": None} for k in names}
    acc["ssd_table"]["lib"] = 0.0
    acc["box_energies"]["lib"] = 0.0
    alone_ms = 0.0
    lib = runtime.kernel_lib("me_ssd")
    for size, r in ((32, 64), (16, 16)):
        ny, nx = h // size, w // size
        nyx, aw, n = 2 * r + 1, 2 * r + size, (h // size) * (w // size)
        roi = refp[PAD - r:PAD - r + (ny - 1) * size + aw,
                   PAD - r:PAD - r + (nx - 1) * size + aw]
        kw = dict(size=size, r=r, ny=ny, nx=nx)
        grid = f"{size}x{size} r={r}"
        t = {}

        box_k = me_ssd.box_energies(roi, size)
        rc = roi.to(torch.int32) - 128
        box_p = me_ssd._box_energies(rc * rc, size)
        torch.cuda.synchronize()
        e = max_abs_err(box_k, box_p)
        if e != 0:
            raise AssertionError("box_energies disagrees with its plain "
                                 "version")
        c = acc["box_energies"]
        c["err"] = max(c["err"], e)
        fn = lambda: me_ssd.box_energies(roi, size)  # noqa: E731
        t["box_energies"] = (cuda_ms(fn, 5), cuda_ms(fn, 20, queued=True))
        c["plain_ms"] += cuda_ms(lambda: me_ssd._box_energies(
            (roi.to(torch.int32) - 128) ** 2, size), 5)
        # yardstick: one average pool over the float32 squares with divisor
        # 1, exact (every partial sum is an integer below 2^24)
        sq = ((roi.to(torch.float32) - 128) ** 2)[None, None]
        fn = lambda: torch.nn.functional.avg_pool2d(  # noqa: E731
            sq, size, stride=1, divisor_override=1)
        e_lib = int((fn()[0, 0] - box_k.to(torch.float32)).abs().max())
        lib_ms = cuda_ms(fn, 5)
        c["lib"] += lib_ms
        log(f"  box_energies {grid}: library avg_pool2d {lib_ms:.4f} ms, "
            f"max_abs_err against the kernel {e_lib}")
        if e_lib != 0:
            raise AssertionError("avg_pool2d disagrees with box_energies")
        del sq
        c["bytes_b"] += roi.numel() + box_k.numel() * 4
        # a square per input sample, two sliding-sum steps per output
        c["ops_b"] += 2.0 * roi.numel() + 4.0 * box_k.numel()
        del rc, box_p

        ssd_k = me_ssd._ssd_table(roi, orig, **kw)
        ssd_p = me_ssd._ssd_table_plain(roi, orig, **kw)
        torch.cuda.synchronize()
        e = max_abs_err(ssd_k, ssd_p)
        log(f"  ssd_table {grid} ({ny}x{nx} blocks, {nyx}x{nyx} offsets): "
            f"max_abs_err {e}")
        if e != 0:
            raise AssertionError("ssd_table disagrees with its plain version")
        a = acc["ssd_table"]
        a["err"] = max(a["err"], e)
        fn = lambda: me_ssd._ssd_table(roi, orig, **kw)  # noqa: E731
        t["ssd_table"] = (cuda_ms(fn, 5), cuda_ms(fn, 20, queued=True))
        stream = runtime.stream_of(roi)
        rcs = []

        def alone():
            rcs.append(lib.hevc_ssd_table(
                roi.data_ptr(), roi.stride(0), orig.data_ptr(),
                orig.stride(0), box_k.data_ptr(), box_k.stride(0),
                ssd_k.data_ptr(), size, r, ny, nx, stream))
        t_alone = cuda_ms(alone, 20, queued=True)
        if any(rcs):
            raise AssertionError(f"ssd_table kernel alone: launch error "
                                 f"{max(rcs)}")
        alone_ms += t_alone
        a["plain_ms"] += cuda_ms(
            lambda: me_ssd._ssd_table_plain(roi, orig, **kw), 2)
        a["bytes_b"] += roi.numel() + n * size * size + ssd_k.numel() * 4
        a["ops_b"] += 2.0 * n * nyx * nyx * size * size
        # yardstick: the cross term alone as one cuDNN grouped convolution
        # in float32 (exact below 2^24; TF32 off)
        torch.backends.cudnn.allow_tf32 = False
        areas = (roi.to(torch.float32) - 128).unfold(0, aw, size).unfold(
            1, aw, size).reshape(1, n, aw, aw).contiguous()
        blks = (orig[:ny * size, :nx * size].to(torch.float32) - 128).reshape(
            ny, size, nx, size).permute(0, 2, 1, 3).reshape(n, 1, size, size)
        a["lib"] += cuda_ms(lambda: torch.nn.functional.conv2d(
            areas, blks, groups=n), 3)
        del areas, blks, box_k

        bits0 = me_ssd._bits0_dev(r, dev)
        akw = dict(r=r, ny=ny, nx=nx)
        idx_k = me_ssd._argmin_two_pass(ssd_k, bits0, lam_q8, size=size,
                                        **akw)
        idx_p = me_ssd._argmin_two_pass_plain(ssd_k, bits0, lam_q8,
                                              local_only=False, **akw)
        torch.cuda.synchronize()
        e = max_abs_err(idx_k, idx_p)
        log(f"  argmin_two_pass {grid}: max_abs_err {e}")
        if e != 0:
            raise AssertionError("argmin_two_pass disagrees with its plain "
                                 "version")
        b = acc["argmin_two_pass"]
        b["err"] = max(b["err"], e)
        fn = lambda: me_ssd._argmin_two_pass(  # noqa: E731
            ssd_k, bits0, lam_q8, size=size, **akw)
        t["argmin_two_pass"] = (cuda_ms(fn, 5), cuda_ms(fn, 20, queued=True))
        b["plain_ms"] += cuda_ms(lambda: me_ssd._argmin_two_pass_plain(
            ssd_k, bits0, lam_q8, local_only=False, **akw), 3)
        b["bytes_b"] += ssd_k.numel() * 4 + bits0.numel() * 4 + n * 4
        # pass 1: nine neighbour adds + compare; pass 2: two mv_bits, the
        # rate product, add and two compares
        b["ops_b"] += 16.0 * n * nyx * nyx
        for k, (ms, q_ms) in t.items():
            acc[k]["ms"] += ms
            acc[k]["q_ms"] += q_ms
        log(f"  {grid} ms (queued behind a sleep in brackets): " + ", ".join(
            f"{k} {ms:.4f} ({q_ms:.4f})" for k, (ms, q_ms) in t.items())
            + f"; ssd_table kernel alone ({t_alone:.4f})")
        del ssd_k, ssd_p
    for name, replaces, rate in (
            ("ssd_table", "hevc_tpu/ops/me_mxu.py:49", INT8_TC_OPS),
            ("argmin_two_pass", "hevc_tpu/ops/me_mxu.py:213", SCALAR32_OPS),
            ("box_energies", "hevc_tpu/ops/me_mxu.py:124", SCALAR32_OPS)):
        a = acc[name]
        bms, by = bound_ms(a["bytes_b"], a["ops_b"], rate)
        results[name] = {
            "name": name, "route": "cuda",
            "source": "hevc_tpu_torch/csrc/me_ssd.cu", "replaces": replaces,
            "max_abs_err": a["err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": a["lib"]}
        log(f"  {name} (one reference, both grids): kernel_ms {a['ms']:.4f} "
            f"(queued {a['q_ms']:.4f}) plain_ms {a['plain_ms']:.3f} "
            f"bound_ms {bms:.4f} ({by})"
            + (f" library_ms {a['lib']:.4f}" if a["lib"] else ""))
    log(f"  ssd_table kernel alone (both grids, box plane precomputed, "
        f"queued): {alone_ms:.4f} ms")
    time_torch_ops(frames, dev)
    check_intra_screen(frames, results)
    check_deep_kernels(frames, results)
    check_option_kernels(frames, results)

    mma_probe(dev)
    rate = vabsdiff4_peak(dev)
    vabsdiff4_probe(dev, rate)
    blks, areas = check_sad_tables(orig, refp, lam_fp, rate, seed, results)
    check_planes(orig, refp, lam_fp, rate, blks, areas, results)
    runtime.reset_launches()


def time_torch_ops(frames, dev):
    """Time of the main path's device work that is a torch call, not a
    kernel of this package (the reference ran it as an XLA program): the
    reference padding (_pad_edge_dev, one F.pad(mode="replicate")) on the
    uint8 plane and on its 10-bit int16 copy, each held to the edge
    extension by two index gathers. Logged only."""
    from hevc_tpu_torch.ops import me_ssd

    def gathers(p):
        rows = torch.arange(-PAD, p.shape[0] + PAD, device=dev).clamp_(
            0, p.shape[0] - 1)
        cols = torch.arange(-PAD, p.shape[1] + PAD, device=dev).clamp_(
            0, p.shape[1] - 1)
        return p.index_select(0, rows).index_select(1, cols)
    h, w = frames[0].shape
    for plane in (torch.from_numpy(frames[0]).to(dev),
                  torch.from_numpy(deep_plane(frames[0], 10)).to(dev)):
        if not torch.equal(me_ssd._pad_edge_dev(plane, PAD), gathers(plane)):
            raise AssertionError(f"_pad_edge_dev disagrees with the index "
                                 f"gathers on the {plane.dtype} plane")
        ms = cuda_ms(lambda: me_ssd._pad_edge_dev(plane, PAD), 20)
        nbytes = (plane.numel() + (h + 2 * PAD) * (w + 2 * PAD)) * \
            plane.element_size()
        bms, by = bound_ms(nbytes, 0, SCALAR32_OPS)
        log(f"  _pad_edge_dev {w}x{h} pad {PAD}, {plane.dtype}: {ms:.4f} ms "
            f"(the index gathers {cuda_ms(lambda: gathers(plane), 20):.4f}), "
            f"bound {bms:.4f} ms ({by}); equal")


def check_intra_screen(frames, results):
    """The intra prescreen kernel (all four block sizes, one launch each)
    against its plain version (the torch ops it replaces) on 1080p planes:
    the 8-bit frame, the same at 10 bits, and the frame with flat 64x64
    patches where many modes tie. The mode costs are the encoder's at QP
    32. Exact equality; the 8-bit plane is timed."""
    from hevc_tpu_torch.ops import intra_screen
    dev = torch.device("cuda")
    h, w = frames[0].shape
    sqrt_lam = (0.57 * 2.0 ** ((32 - 12) / 3.0)) ** 0.5
    lam_tab = torch.tensor([round(sqrt_lam * intra_screen._mode_bits_est(m))
                            for m in range(35)], dtype=torch.int32,
                           device=dev)
    flat = frames[1].astype(np.int16)
    for y0 in range(0, h - 64, 128):
        for x0 in range(0, w - 64, 128):
            flat[y0:y0 + 64, x0:x0 + 64] = 60 + (y0 + x0) // 16
    planes = {"8-bit": (frames[0].astype(np.int16), 8),
              "10-bit": ((frames[1].astype(np.int16) << 2)
                         | (frames[0].astype(np.int16) & 3), 10),
              "8-bit flat regions": (flat, 8)}
    err = 0
    for name, (y, bd) in planes.items():
        p = np.full((h + 1, w + 1), 1 << (bd - 1), np.int16)
        p[1:, 1:] = y
        plane = torch.from_numpy(p).to(dev)
        got = intra_screen.intra_screen(plane, lam_tab, bit_depth=bd)
        exp = intra_screen.intra_screen_plain(plane, lam_tab, bit_depth=bd)
        torch.cuda.synchronize()
        e = max(max_abs_err(a, b) for a, b in zip(got, exp))
        same_shape = all(a.shape == b.shape and a.dtype == b.dtype
                         for a, b in zip(got, exp))
        log(f"  intra_screen {w}x{h} {name} (sizes 4-32, "
            f"{got[1].numel()} blocks, {got[0].numel()} candidates): "
            f"max_abs_err {e}")
        if e != 0 or not same_shape:
            raise AssertionError(f"intra_screen disagrees with its plain "
                                 f"version on the {name} plane")
        err = max(err, e)
        if name == "8-bit":
            timed = (plane, got)
    plane, got = timed
    fn = lambda: intra_screen.intra_screen(  # noqa: E731
        plane, lam_tab, bit_depth=8)
    ms, q_ms = cuda_ms(fn, 20), cuda_ms(fn, 20, queued=True)
    pms = cuda_ms(lambda: intra_screen.intra_screen_plain(
        plane, lam_tab, bit_depth=8), 3)
    per_size = {1 << lg: cuda_ms(lambda lg=lg: intra_screen.intra_screen(
        plane, lam_tab, bit_depth=8, log2s=(lg,)), 20, queued=True)
        for lg in (2, 3, 4, 5)}
    log("  intra_screen per launch, queued (ms): " + ", ".join(
        f"{n}x{n} {t:.4f}" for n, t in per_size.items()))
    # operations per predicted sample and mode: the angular blend (6), the
    # difference (1), the butterflies (2 log2 of the tile side), abs and
    # sum (2); samples: the blocks' own, per size
    ops = sum(35.0 * b * n * n * (9 + (6 if n >= 8 else 4))
              for (_, n, _, _, _, b) in intra_screen._sizes(
                  w, h, (2, 3, 4, 5)))
    nbytes = plane.numel() * 2 + 35 * 4 + got[0].numel() + \
        got[1].numel() * 4
    bms, by = bound_ms(nbytes, ops, SCALAR32_OPS)
    results["intra_screen"] = {
        "name": "intra_screen", "route": "cuda",
        "source": "hevc_tpu_torch/csrc/intra_screen.cu",
        "replaces": "hevc_tpu/ops/intra_screen.py:96", "max_abs_err": err,
        "ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
        "library_ms": None}
    log(f"  intra_screen (one 1080p picture, four launches): kernel_ms "
        f"{ms:.4f} (queued {q_ms:.4f}) plain_ms (torch ops) {pms:.3f} "
        f"bound_ms {bms:.4f} ({by}, {ops / 1e9:.2f} G ops)")


def check_deep_kernels(frames, results):
    """The deep search kernels (ssd_table_deep and the box_energies_deep
    launch it makes first) against their plain versions at the 1080p shapes
    of both grids of the Main10 path: the two frames at 10 and at 12 bits,
    and at 10 bits with flat 64x64 patches in both planes (many offsets
    tie). Exact equality. The 10-bit planes are timed: host-paced and
    queued, plain version, the ssd kernel alone (its box plane
    precomputed) and its staging probe (the same launch without its
    products), with the multiply-adds the kernel issues against the
    unpadded count, and the library yardsticks, timed only: cuDNN's
    float32 grouped convolution of the centred samples (the correlation)
    and avg_pool2d of the float32 squares, whose sums above 2^24 are not
    exact."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    dev = torch.device("cuda")
    h, w = frames[0].shape
    flat = [f.copy() for f in frames[:2]]
    for f in flat:
        for y0 in range(0, h - 64, 128):
            for x0 in range(0, w - 64, 128):
                f[y0:y0 + 64, x0:x0 + 64] = 60 + (y0 + x0) // 16
    cases = {"10-bit": (frames, 10), "12-bit": (frames, 12),
             "10-bit flat regions": (flat, 10)}
    names = ("ssd_table_deep", "box_energies_deep")
    acc = {k: {"ms": 0.0, "q_ms": 0.0, "plain_ms": 0.0, "bytes_b": 0.0,
               "ops_b": 0.0, "err": 0, "lib": 0.0} for k in names}
    alone_ms = stage_ms = 0.0
    lib = runtime.kernel_lib("me_ssd")
    torch.backends.cudnn.allow_tf32 = False
    for case, (fr, bd) in cases.items():
        orig = torch.from_numpy(deep_plane(fr[1], bd)).to(dev)
        refp = me_ssd.pad_ref_device(
            torch.from_numpy(deep_plane(fr[0], bd)).to(dev), PAD)
        shift, mid = me_ssd.deep_centring(bd)
        for size, r in ((32, 64), (16, 16)):
            ny, nx = h // size, w // size
            nyx, aw, n = 2 * r + 1, 2 * r + size, (h // size) * (w // size)
            roi = refp[PAD - r:PAD - r + (ny - 1) * size + aw,
                       PAD - r:PAD - r + (nx - 1) * size + aw]
            kw = dict(size=size, r=r, ny=ny, nx=nx, depth=bd)
            grid = f"{size}x{size} r={r}"
            box_k = me_ssd.box_energies(roi, size, shift, mid)
            rc = (roi.to(torch.int32) >> shift) - mid
            box_p = me_ssd._box_energies(rc * rc, size)
            ssd_k = me_ssd._ssd_table_deep(roi, orig, **kw)
            ssd_p = me_ssd._ssd_table_deep_plain(roi, orig, **kw)
            torch.cuda.synchronize()
            e_box, e_ssd = max_abs_err(box_k, box_p), max_abs_err(ssd_k, ssd_p)
            log(f"  deep {case} {grid} (shift {shift}, mid {mid}): "
                f"box_energies_deep max_abs_err {e_box}, ssd_table_deep "
                f"max_abs_err {e_ssd}")
            if e_box != 0 or e_ssd != 0:
                raise AssertionError(f"a deep kernel disagrees with its plain "
                                     f"version on the {case} planes")
            acc["box_energies_deep"]["err"] = max(
                acc["box_energies_deep"]["err"], e_box)
            acc["ssd_table_deep"]["err"] = max(acc["ssd_table_deep"]["err"],
                                               e_ssd)
            del box_p, ssd_p
            if case != "10-bit":
                continue
            t = {}
            c = acc["box_energies_deep"]
            fn = lambda: me_ssd.box_energies(  # noqa: E731
                roi, size, shift, mid)
            t["box_energies_deep"] = (cuda_ms(fn, 5),
                                      cuda_ms(fn, 20, queued=True))
            c["plain_ms"] += cuda_ms(lambda: me_ssd._box_energies(
                ((roi.to(torch.int32) >> shift) - mid) ** 2, size), 5)
            sq = (rc.to(torch.float32) ** 2)[None, None]
            fn = lambda: torch.nn.functional.avg_pool2d(  # noqa: E731
                sq, size, stride=1, divisor_override=1)
            e_lib = float((fn()[0, 0] - box_k.to(torch.float32)).abs().max())
            lib_ms = cuda_ms(fn, 5)
            c["lib"] += lib_ms
            log(f"  box_energies_deep {grid}: library avg_pool2d "
                f"{lib_ms:.4f} ms (float32, not exact here: max_abs_err "
                f"{e_lib:g} against the kernel)")
            del sq
            c["bytes_b"] += roi.numel() * 2 + box_k.numel() * 4
            # shift, centre and square per input sample, two sliding-sum
            # steps per output
            c["ops_b"] += 3.0 * roi.numel() + 4.0 * box_k.numel()

            a = acc["ssd_table_deep"]
            fn = lambda: me_ssd._ssd_table_deep(roi, orig, **kw)  # noqa: E731
            t["ssd_table_deep"] = (cuda_ms(fn, 5), cuda_ms(fn, 20, queued=True))
            stream = runtime.stream_of(roi)
            rcs = []

            def alone():
                rcs.append(lib.hevc_ssd_table_deep(
                    roi.data_ptr(), roi.stride(0), orig.data_ptr(),
                    orig.stride(0), box_k.data_ptr(), box_k.stride(0),
                    ssd_k.data_ptr(), size, r, ny, nx, shift, mid, stream))
            t_alone = cuda_ms(alone, 20, queued=True)

            def stage():  # the staging probe: the launch without products
                rcs.append(lib.hevc_ssd_table_deep_stage(
                    roi.data_ptr(), roi.stride(0), orig.data_ptr(),
                    orig.stride(0), box_k.data_ptr(), box_k.stride(0),
                    ssd_k.data_ptr(), size, r, ny, nx, shift, mid, stream))
            t_stage = cuda_ms(stage, 20, queued=True)
            if any(rcs):
                raise AssertionError(f"ssd_table_deep kernel alone: launch "
                                     f"error {max(rcs)}")
            alone_ms += t_alone
            stage_ms += t_stage
            padded = me_ssd.deep_padded_macs(size, r, n)
            log(f"  ssd_table_deep {grid}: kernel alone {t_alone:.4f} ms, "
                f"its staging alone (probe) {t_stage:.4f} ms, products "
                f"(the difference) {t_alone - t_stage:.4f} ms; "
                f"{padded / 1e9:.2f} G multiply-adds a product issued, "
                f"{padded / (n * nyx * nyx * size * size):.3f}x the "
                f"unpadded")
            a["plain_ms"] += cuda_ms(
                lambda: me_ssd._ssd_table_deep_plain(roi, orig, **kw), 2)
            a["bytes_b"] += (roi.numel() * 2 + n * size * size * 2
                             + ssd_k.numel() * 4)
            # three int8 products, two operations a multiply-add
            a["ops_b"] += 3 * 2.0 * n * nyx * nyx * size * size
            areas = rc.to(torch.float32).unfold(0, aw, size).unfold(
                1, aw, size).reshape(1, n, aw, aw).contiguous()
            blks = ((orig[:ny * size, :nx * size].to(torch.int32) >> shift)
                    - mid).to(torch.float32).reshape(ny, size, nx, size)
            blks = blks.permute(0, 2, 1, 3).reshape(n, 1, size, size)
            a["lib"] += cuda_ms(lambda: torch.nn.functional.conv2d(
                areas, blks, groups=n), 3)
            del areas, blks
            for k, (ms, q_ms) in t.items():
                acc[k]["ms"] += ms
                acc[k]["q_ms"] += q_ms
            log(f"  deep 10-bit {grid} ms (queued in brackets): " + ", ".join(
                f"{k} {ms:.4f} ({q_ms:.4f})" for k, (ms, q_ms) in t.items())
                + f"; ssd_table_deep kernel alone ({t_alone:.4f})")
            del ssd_k, box_k, rc
    for name, replaces, rate in (
            ("ssd_table_deep", "hevc_tpu/ops/me_mxu.py:142", INT8_TC_OPS),
            ("box_energies_deep", "hevc_tpu/ops/me_mxu.py:124",
             SCALAR32_OPS)):
        a = acc[name]
        bms, by = bound_ms(a["bytes_b"], a["ops_b"], rate)
        results[name] = {
            "name": name, "route": "cuda",
            "source": "hevc_tpu_torch/csrc/me_ssd.cu", "replaces": replaces,
            "max_abs_err": a["err"], "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": a["lib"],
            "queued_ms": a["q_ms"]}
        log(f"  {name} (10-bit, one reference, both grids): kernel_ms "
            f"{a['ms']:.4f} (queued {a['q_ms']:.4f}) plain_ms "
            f"{a['plain_ms']:.3f} bound_ms {bms:.4f} ({by}, "
            f"{a['ops_b'] / 1e9:.1f} G ops, {a['bytes_b'] / 1e6:.1f} MB) "
            f"library_ms {a['lib']:.4f}")
    log(f"  ssd_table_deep kernel alone (10-bit, both grids, box plane "
        f"precomputed, queued): {alone_ms:.4f} ms; staging probe "
        f"{stage_ms:.4f} ms, products {alone_ms - stage_ms:.4f} ms")


def refine_ops(size, cy, cx):
    """32-bit integer operations of the refine tables for blocks whose half
    winners are (cy, cx) [n]: a multiply-add counts 2 (taps that are 0
    are not counted), a shift, add, abs or compare 1. Interpolation: the
    half stage's three fractional phases over the (size + 1)^2 samples its
    nine tiles cover (phase (2, 2) by a horizontal pass over size + 8
    rows); each quarter candidate's tile, one horizontal pass per distinct
    horizontal phase shared by its rows. SATD: 17 tiles of size^2
    differences (a subtraction, 6 butterfly operations, an abs and an add
    each). Work that the data decides (the quarter phases) is counted for
    this run's half winners."""
    taps = (0, 7, 8, 7)
    side = size + 1
    half = (2 * side * side * (2 * 8 + 5) + (size + 8) * side * (2 * 8 + 1)
            + side * side * (2 * 8 + 5))
    satd = 17 * size * size * 9
    per = {}
    for hy in (-2, 0, 2):
        for hx in (-2, 0, 2):
            ops, hpass = 0, {}
            for qy in (hy - 1, hy, hy + 1):
                for qx in (hx - 1, hx, hx + 1):
                    if (qy, qx) == (hy, hx):
                        continue
                    fy, fx = qy & 3, qx & 3
                    if fy and fx:
                        hpass.setdefault(fx, set()).add(qy >> 2)
                        ops += size * size * (2 * taps[fy] + 5)
                    else:
                        ops += size * size * (2 * taps[fy or fx] + 5)
            for fx, shifts in hpass.items():
                ops += (size + 6 + len(shifts)) * size * (2 * taps[fx] + 1)
            per[(hy, hx)] = ops
    cyx = torch.stack([cy, cx], 1).cpu().numpy()
    quarter = sum(per[(int(a), int(b))] for a, b in cyx)
    return float(len(cyx) * (half + satd) + quarter)


def ptxas_entries(lib, key):
    """(kernel, ptxas line) of every entry function of _build/<lib>.log
    whose name holds `key`: the registers, stack and static shared memory
    that nvcc -Xptxas -v printed for it. Names demangled by cu++filt."""
    from hevc_tpu_torch import runtime
    with open(os.path.join(runtime.BUILD_DIR, f"{lib}.log")) as fh:
        lines = fh.read().splitlines()
    names, out = [], []
    for line in lines:
        if "Compiling entry function" in line:
            names.append(line.split("'")[1])
        elif (("registers" in line or "spill" in line) and names
              and key in names[-1]):
            out.append((names[-1], line.split("ptxas info    :")[-1].strip()))
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if out and os.path.exists(tool):
        dem = subprocess.run([tool] + [n for n, _ in out], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(dem) == len(out):
            out = [(d.rsplit("(", 1)[0], ln) for d, (_, ln) in zip(dem, out)]
    return out


def refine_launch(entry, orig, refp, gidx, *, size, r, ny, nx, pad, depth):
    """One launch of a refine_tables C entry (the kernel or its half-stage
    probe) into fresh outputs, on the current stream; no count."""
    from hevc_tpu_torch import runtime
    lib = runtime.kernel_lib("me_refine")
    off = torch.empty(ny * nx, dtype=torch.int32, device=refp.device)
    half = torch.empty_like(off)
    rc = getattr(lib, entry)(
        orig.data_ptr(), orig.stride(0), refp.data_ptr(), refp.stride(0),
        refp.shape[0], refp.shape[1], refp.element_size(), gidx.data_ptr(),
        size, r, ny, nx, pad, depth, off.data_ptr(), half.data_ptr(),
        runtime.stream_of(refp))
    if rc != 0:
        raise AssertionError(f"{entry}: launch error {rc}")
    return off, half


def check_option_kernels(frames, results):
    """The search options' kernels (csrc/me_refine.cu) against their plain
    versions at 1080p shapes, exactly. wp_apply: the padded reference at 8
    and 10 bits under a fade's weight, a negative weight with a negative
    offset, and denom 0, one plane a launch and four; timed at 1, 2 and 4
    padded 8-bit planes a launch (the kernels line: 4), beside a
    device-to-device copy of the same bytes, the floor of any elementwise
    pass. refine_tables: both grids of the main path at 8 and 10 bits, at
    the integer MVs the search finds (timed, at 8 bits, each grid and its
    half stage alone through the probe entry) and with every block's MV at
    a corner or edge of its window (+-r). The bound of wp_apply is its
    bytes; that of refine_tables its operations (refine_ops) over the
    67 T/s 32-bit rate. Prints each refine instance's registers (build
    log) and dynamic shared memory."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    dev = torch.device("cuda")
    h, w = frames[0].shape
    wps = ((51, -3, 6), (-20, -7, 3), (3, 10, 0))
    acc = {"wp_apply": {"ms": 0.0, "q_ms": 0.0, "plain_ms": 0.0,
                        "err": 0, "bytes": 0.0, "ops": 0.0},
           "refine_tables": {"ms": 0.0, "q_ms": 0.0, "plain_ms": 0.0,
                             "err": 0, "bytes": 0.0, "ops": 0.0,
                             "half_q_ms": 0.0}}
    lib = runtime.kernel_lib("me_refine")
    for name, line in ptxas_entries("me_refine", "kernel"):
        log(f"  ptxas {name}: {line}")
    for size in (32, 16):
        for wide in (0, 1):
            log(f"  refine_tables {size}x{size}{' WIDE' if wide else ''}: "
                f"{lib.hevc_refine_tables_smem(size, wide)} bytes of dynamic "
                f"shared memory a thread block")
    by_planes = {}
    for bd in (8, 10):
        conv = (lambda p: p) if bd == 8 else (lambda p: deep_plane(p, bd))
        orig = torch.from_numpy(conv(frames[1])).to(dev)
        refp = me_ssd.pad_ref_device(torch.from_numpy(conv(frames[0])).to(
            dev), PAD)
        a = acc["wp_apply"]
        for wpv in wps:
            got = me_ssd.wp_apply(refp, wpv, bd)
            e = max_abs_err(got, me_ssd.wp_apply_plain(refp, wpv, bd))
            log(f"  wp_apply {bd}-bit {tuple(refp.shape)} {wpv}: max_abs_err "
                f"{e}")
            if e != 0:
                raise AssertionError("wp_apply disagrees with its plain "
                                     "version")
            a["err"] = max(a["err"], e)
        planes4 = [refp, refp.flip(0).contiguous(), refp.roll(7, 1),
                   refp.flip(1).contiguous()]
        wps4 = list(wps) + [(1, 0, 0)]
        got = me_ssd.wp_apply_multi(planes4, wps4, bd)
        e = max(max_abs_err(x, y) for x, y in zip(
            got, me_ssd.wp_apply_multi_plain(planes4, wps4, bd)))
        log(f"  wp_apply_multi {bd}-bit, 4 planes {tuple(refp.shape)}: "
            f"max_abs_err {e}")
        if e != 0:
            raise AssertionError("wp_apply_multi disagrees with its plain "
                                 "version")
        if bd == 8:
            for k in (1, 2, 4):
                pl, tr = planes4[:k], wps4[:k]
                fn = lambda: me_ssd.wp_apply_multi(pl, tr, bd)  # noqa: E731
                nbytes = 2.0 * sum(p.numel() for p in pl)
                dst = torch.empty(k * refp.numel(), dtype=refp.dtype,
                                  device=dev)
                src = torch.cat([p.reshape(-1) for p in pl])
                d = {"ms": cuda_ms(fn, 20),
                     "queued_ms": cuda_ms(fn, 50, queued=True),
                     "copy_queued_ms": cuda_ms(lambda: dst.copy_(src), 50,
                                               queued=True),
                     "plain_ms": cuda_ms(lambda: me_ssd.wp_apply_multi_plain(
                         pl, tr, bd), 5),
                     "bound_ms": nbytes / HBM_BPS * 1e3, "bytes": nbytes}
                by_planes[k] = d
                del dst, src
                log(f"  wp_apply_multi 8-bit, {k} plane(s) a launch "
                    f"({nbytes / 1e6:.2f} MB): queued "
                    f"{d['queued_ms']:.4f} ms, "
                    f"host {d['ms']:.4f} ms, bound {d['bound_ms']:.4f} ms "
                    f"(bytes, {100 * d['bound_ms'] / d['queued_ms']:.1f}%); "
                    f"copy floor (device-to-device copy_ of the same bytes, "
                    f"queued) {d['copy_queued_ms']:.4f} ms; plain "
                    f"{d['plain_ms']:.3f} ms")
            d = by_planes[4]
            a.update(ms=d["ms"], q_ms=d["queued_ms"], plain_ms=d["plain_ms"],
                     bytes=d["bytes"],
                     ops=6.0 * 4 * refp.numel())  # mul, add, shift, add, clip
        del planes4, got
        a = acc["refine_tables"]
        for size, r in ((32, 64), (16, 16)):
            ny, nx, nyx = h // size, w // size, 2 * r + 1
            kwp = dict(size=size, r=r, ny=ny, nx=nx, pad=PAD)
            kw = dict(kwp, depth=bd)
            found = me_ssd.me_idx_frame(orig, refp, me_ssd._bits0_dev(r, dev),
                                        100, **kw)
            ends = torch.tensor([(dy + r) * nyx + dx + r for dy in (-r, 0, r)
                                 for dx in (-r, 0, r)], dtype=torch.int32,
                                device=dev).repeat(ny * nx // 9 + 1)
            phases = me_ssd._build_phases_plain(refp, bd)
            for mvs, gidx in (("found", found), ("edges", ends[:ny * nx])):
                got = me_ssd.refine_tables(orig, refp, gidx, **kw)
                exp = me_ssd._refine_direct_plain(orig, phases, gidx, **kwp)
                e = max(max_abs_err(x, y) for x, y in zip(got, exp))
                log(f"  refine_tables {bd}-bit {size}x{size} r={r} "
                    f"({ny * nx} blocks, MVs {mvs}): max_abs_err {e}; "
                    f"offsets used {torch.unique(got[0]).numel()} of 49")
                if e != 0:
                    raise AssertionError("refine_tables disagrees with its "
                                         "plain version")
                a["err"] = max(a["err"], e)
            # the half winners decide the quarter stage's phases
            ob, base_r, base_c = me_ssd._refine_setup(orig, found, **kwp)
            _, cy, cx, hmin = me_ssd._refine_half_plain(ob, phases, base_r,
                                                        base_c, size)
            poff, phalf = refine_launch("hevc_refine_tables_half", orig, refp,
                                        found, **kw)
            e = max(max_abs_err(poff, (cy + 3) * 7 + cx + 3),
                    max_abs_err(phalf, hmin))
            if e != 0:
                raise AssertionError("the refine_tables half-stage probe "
                                     "disagrees with the plain half stage")
            if bd != 8:
                continue
            del phases
            fn = lambda: me_ssd.refine_tables(  # noqa: E731
                orig, refp, found, **kw)
            ms, q_ms = cuda_ms(fn, 10), cuda_ms(fn, 20, queued=True)
            half_q = cuda_ms(lambda: refine_launch(
                "hevc_refine_tables_half", orig, refp, found, **kw), 20,
                queued=True)
            a["ms"] += ms
            a["q_ms"] += q_ms
            a["half_q_ms"] += half_q
            a["plain_ms"] += cuda_ms(lambda: me_ssd._refine_direct_plain(
                orig, me_ssd._build_phases_plain(refp, bd), found, **kwp), 2)
            ops = refine_ops(size, cy, cx)
            a["ops"] += ops
            a["bytes"] += (refp.numel() + ny * nx * size * size
                           + 3 * 4 * ny * nx)
            log(f"  refine_tables 8-bit {size}x{size} r={r}: {ms:.4f} ms "
                f"(queued {q_ms:.4f}; its half stage alone, probe, queued "
                f"{half_q:.4f}, so the quarter stage {q_ms - half_q:.4f}), "
                f"{ops / 1e9:.3f} G ops (bound "
                f"{ops / SCALAR32_OPS * 1e3:.4f} ms, "
                f"{100 * ops / SCALAR32_OPS * 1e3 / q_ms:.1f}% queued); half "
                f"winners off the centre {int(((cy != 0) | (cx != 0)).sum())} "
                f"of {ny * nx}")
    for name, replaces in (("wp_apply", "hevc_tpu/ops/me_mxu.py:452"),
                           ("refine_tables", "hevc_tpu/ops/me_mxu.py:370")):
        a = acc[name]
        bms, by = bound_ms(a["bytes"], a["ops"], SCALAR32_OPS)
        results[name] = {
            "name": name, "route": "cuda",
            "source": "hevc_tpu_torch/csrc/me_refine.cu",
            "replaces": replaces, "max_abs_err": a["err"], "ms": a["ms"],
            "plain_ms": a["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": None, "queued_ms": a["q_ms"]}
        what = ("both grids" if name == "refine_tables"
                else "4 planes a launch")
        log(f"  {name} (8-bit, {what}): kernel_ms {a['ms']:.4f} (queued "
            f"{a['q_ms']:.4f}) plain_ms {a['plain_ms']:.3f} bound_ms "
            f"{bms:.4f} ({by}, {a['ops'] / 1e9:.3f} G ops, "
            f"{a['bytes'] / 1e6:.2f} MB); share of the bound (queued) "
            f"{100 * bms / a['q_ms']:.1f}%")
    results["refine_tables"]["half_queued_ms"] = acc["refine_tables"][
        "half_q_ms"]
    results["wp_apply"]["by_planes"] = by_planes


def mma_probe(dev):
    """The int8 mma.sync rate of the card, printed only: the probe kernel
    of csrc/me_ssd.cu (8 independent m16n8k32 u8 x s8 chains a warp, on
    register operands, 2 and 4 thread blocks of 8 warps an SM), timed
    queued, against the published 1979 TOP/s dense int8 peak."""
    from hevc_tpu_torch import runtime
    lib = runtime.kernel_lib("me_ssd")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    iters = 4096
    for per_sm in (2, 4):
        blocks = per_sm * sms
        out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
        rcs = []
        ms = cuda_ms(lambda: rcs.append(lib.hevc_mma_probe(
            out.data_ptr(), blocks, iters, runtime.stream_of(out))), 5,
            queued=True)
        if any(rcs):
            raise AssertionError(f"mma probe: launch error {max(rcs)}")
        ops = blocks * 8 * iters * 8 * 16 * 8 * 32 * 2.0
        log(f"  mma.sync m16n8k32 u8 x s8 probe, {8 * per_sm} warps an SM: "
            f"{ops / ms / 1e9:.1f} T ops/s, "
            f"{100 * ops / ms / 1e9 / (INT8_TC_OPS / 1e12):.1f}% of the "
            f"1979 T dense int8 peak ({ms:.4f} ms a call)")


def vabsdiff4_peak(dev):
    """The card's peak VABSDIFF4 rate, instructions a second: the published
    64 a clock an SM, times the SM count and the maximum SM clock that
    nvidia-smi reads. The 8-bit path's operations bound is a quarter of its
    differences over this rate."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    mhz = float(smi.stdout.strip().splitlines()[0])
    rate = VABSDIFF4_PER_CLK_SM * sms * mhz * 1e6
    log(f"  VABSDIFF4 peak: {VABSDIFF4_PER_CLK_SM} a clock an SM x {sms} "
        f"SMs x {mhz:.0f} MHz = {rate / 1e12:.3f} T instructions/s")
    return rate


def vabsdiff4_probe(dev, peak):
    """A check of the published rate, printed only: the probe kernel of
    csrc/sad.cu (16 independent accumulations a thread, 16 thread blocks an
    SM), timed queued."""
    from hevc_tpu_torch import runtime
    lib = runtime.kernel_lib("sad")
    blocks = 16 * torch.cuda.get_device_properties(dev).multi_processor_count
    iters = 2048
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    stream = runtime.stream_of(out)
    rcs = []
    ms = cuda_ms(lambda: rcs.append(lib.hevc_vabsdiff4_probe(
        out.data_ptr(), blocks, iters, stream)), 5, queued=True)
    if any(rcs):
        raise AssertionError(f"vabsdiff4 probe: launch error {max(rcs)}")
    rate = blocks * 256.0 * iters * 16 / (ms * 1e-3)
    log(f"  VABSDIFF4 probe: {rate / 1e12:.3f} T instructions/s, "
        f"{100 * rate / peak:.1f}% of the peak ({ms:.4f} ms a call)")


def sad_bound(nbytes, diffs, bit_depth, rate):
    """Least time of a SAD table: bytes over HBM, or its operations: for
    8-bit samples a quarter of the differences over the peak VABSDIFF4
    rate; otherwise 2 operations a difference at the 32-bit peak."""
    if bit_depth <= 8:
        tb, to = nbytes / HBM_BPS * 1e3, diffs / 4.0 / rate * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")
    return bound_ms(nbytes, 2.0 * diffs, SCALAR32_OPS)


def search_bound(nbytes, diffs, positions, bit_depth, rate):
    """Least time of the fused full search: its bytes over HBM (blocks and
    areas read, four [N] vectors read and four written; no table), or its
    operations: the sweep's, counted as sad_bound counts them, plus 8
    integer operations a position for the cost and the running minimum at
    the 32-bit peak."""
    tb = nbytes / HBM_BPS * 1e3
    sweep = (diffs / 4.0 / rate if bit_depth <= 8
             else 2.0 * diffs / SCALAR32_OPS)
    to = (sweep + 8.0 * positions / SCALAR32_OPS) * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def outputs_err(got, exp):
    """max_abs_err over a kernel's output tensor or tuple of tensors."""
    if isinstance(got, torch.Tensor):
        got, exp = (got,), (exp,)
    return max(max_abs_err(a, b) for a, b in zip(got, exp))


def time_deep(name, fn, plain, bound):
    """The 10-bit case of a kernel already checked at 8 bits: held to its
    plain version, timed host-paced and queued. Returns its numbers."""
    got, exp = fn(), plain()
    torch.cuda.synchronize()
    e = outputs_err(got, exp)
    if e != 0:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"10-bit samples")
    bms, by = bound
    d = {"bit_depth": 10, "max_abs_err": e, "ms": cuda_ms(fn, 3),
         "queued_ms": cuda_ms(fn, 10, queued=True),
         "plain_ms": cuda_ms(plain, 1), "bound_ms": bms, "bound_by": by}
    log(f"  {name} 10-bit: max_abs_err {e} kernel_ms {d['ms']:.4f} (queued "
        f"{d['queued_ms']:.4f}) plain_ms {d['plain_ms']:.3f} bound_ms "
        f"{bms:.4f} ({by})")
    return d


def check_sad_tables(orig, refp, lam_fp, rate, seed, results):
    """The fallback path's full search at its 1080p shape (2048 blocks of
    32x32 in the bucket, 129x129 offsets, mv_min -64, per-block predictors
    made from --seed): the fused kernel of the path, and the table route
    that no encoder path calls any more (sad_table, then sad_cost_argmin
    over its table), whose entry points run first, once each, with the
    launch counters reset just before (their path). On the 8-bit picture
    and on the same << 2 (10 bits: the float path), each kernel is held to
    its plain version (the fused one on all four outputs) and timed
    host-paced and queued. sad_table's yardstick is torch.cdist(p=1) over
    every block (cdist_ms). Returns the int32 blocks and areas."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me, sad
    dev = orig.device
    h, w = orig.shape
    size, R = 32, 64
    pos = [(x0, y0) for y0 in range(0, h - size + 1, size)
           for x0 in range(0, w - size + 1, size)]
    n = len(pos)
    bucket = max(128, 1 << (n - 1).bit_length())
    blks = torch.zeros((bucket, size, size), dtype=torch.int32, device=dev)
    areas = torch.zeros((bucket, size + 2 * R, size + 2 * R),
                        dtype=torch.int32, device=dev)
    o32, r32 = orig.to(torch.int32), refp.to(torch.int32)
    for i, (x0, y0) in enumerate(pos):
        blks[i] = o32[y0:y0 + size, x0:x0 + size]
        areas[i] = r32[PAD + y0 - R:PAD + y0 + R + size,
                       PAD + x0 - R:PAD + x0 + R + size]
    ny = nx = 2 * R + 1
    rng = np.random.default_rng(seed)
    mins = torch.full((bucket,), -R, dtype=torch.int32, device=dev)
    vecs = (mins, mins) + tuple(
        torch.from_numpy(rng.integers(-64, 65, bucket).astype(np.int32)).to(
            dev) for _ in range(2))
    runtime.reset_launches()
    sad_k = sad.sad_table(blks, areas)
    ca_k = sad.cost_argmin(sad_k, *vecs, lam_fp)
    torch.cuda.synchronize()
    path = dict(runtime.launches)
    runtime.reset_launches()
    log(f"  table route entry points (sad_table, cost_argmin): launches "
        f"{path}")
    for k in ("sad_table", "sad_cost_argmin"):
        if path[k] <= 0:
            raise AssertionError(f"{k} was never launched")
    sad_p = sad.sad_table_plain(blks, areas)
    torch.cuda.synchronize()
    e = max_abs_err(sad_k, sad_p)
    log(f"  sad_table N={bucket} {size}x{size} {ny}x{nx}: max_abs_err {e}")
    if e != 0:
        raise AssertionError("sad_table disagrees with its plain version")
    del sad_p
    fn = lambda: sad.sad_table(blks, areas)  # noqa: E731
    ms, q_ms = cuda_ms(fn, 3), cuda_ms(fn, 10, queued=True)
    pms = cuda_ms(lambda: sad.sad_table_plain(blks, areas), 1)
    nbytes = (blks.numel() + areas.numel() + sad_k.numel()) * 4
    diffs = float(bucket) * ny * nx * size * size
    bms, by = sad_bound(nbytes, diffs, 8, rate)
    lib_ms = cdist_ms(blks, areas, bucket, sad_k)
    b10, a10 = blks << 2, areas << 2
    deep = time_deep("sad_table", lambda: sad.sad_table(b10, a10),
                     lambda: sad.sad_table_plain(b10, a10),
                     sad_bound(nbytes, diffs, 10, rate))
    results["sad_table"] = {
        "name": "sad_table", "route": "cuda",
        "source": "hevc_tpu_torch/csrc/sad.cu",
        "replaces": "hevc_tpu/ops/sad_pallas.py:60",
        "launches": path["sad_table"], "max_abs_err": e, "ms": ms,
        "plain_ms": pms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "queued_ms": q_ms, "deep": deep}
    log(f"  sad_table 8-bit: kernel_ms {ms:.4f} (queued {q_ms:.4f}) "
        f"plain_ms {pms:.3f} bound_ms {bms:.4f} ({by}) library_ms "
        f"{lib_ms:.4f} (torch.cdist p=1 over all {bucket} blocks)")

    ca_p = sad.cost_argmin_plain(sad_k, *vecs, lam_fp)
    torch.cuda.synchronize()
    e = outputs_err(ca_k, ca_p)
    log(f"  sad_cost_argmin: max_abs_err {e}")
    if e != 0:
        raise AssertionError("sad_cost_argmin disagrees with its plain "
                             "version")
    fn = lambda: sad.cost_argmin(sad_k, *vecs, lam_fp)  # noqa: E731
    ms, q_ms = cuda_ms(fn, 5), cuda_ms(fn, 20, queued=True)
    pms = cuda_ms(lambda: sad.cost_argmin_plain(sad_k, *vecs, lam_fp), 3)
    bms, by = bound_ms(sad_k.numel() * 4 + 8 * bucket * 4,
                       8.0 * sad_k.numel(), SCALAR32_OPS)
    results["sad_cost_argmin"] = {
        "name": "sad_cost_argmin", "route": "cuda",
        "source": "hevc_tpu_torch/csrc/sad.cu",
        "replaces": "hevc_tpu/ops/me.py:95", "launches":
        path["sad_cost_argmin"], "max_abs_err": e, "ms": ms,
        "plain_ms": pms, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "queued_ms": q_ms}
    log(f"  sad_cost_argmin: kernel_ms {ms:.4f} (queued {q_ms:.4f}) "
        f"plain_ms {pms:.3f} bound_ms {bms:.4f} ({by})")
    del sad_k

    fs_k = sad.full_search_batch_kernel(blks, areas, *vecs, lam_fp)
    fs_p = me.full_search_batch(blks, areas, *vecs, lam_fp)
    torch.cuda.synchronize()
    e = outputs_err(fs_k, fs_p)
    log(f"  full_search (mv_y, mv_x, cost, sad): max_abs_err {e}; equal "
        f"to the table route's: {outputs_err(fs_k, ca_k) == 0}")
    if e != 0 or outputs_err(fs_k, ca_k) != 0:
        raise AssertionError("full_search disagrees with its plain version "
                             "or the table route")
    del fs_p
    fn = lambda: sad.full_search_batch_kernel(  # noqa: E731
        blks, areas, *vecs, lam_fp)
    ms, q_ms = cuda_ms(fn, 3), cuda_ms(fn, 10, queued=True)
    pms = cuda_ms(lambda: me.full_search_batch(blks, areas, *vecs, lam_fp),
                  1)
    positions = float(bucket) * ny * nx
    fbytes = (blks.numel() + areas.numel() + 8 * bucket) * 4
    bms, by = search_bound(fbytes, diffs, positions, 8, rate)
    deep = time_deep(
        "full_search",
        lambda: sad.full_search_batch_kernel(b10, a10, *vecs, lam_fp),
        lambda: me.full_search_batch(b10, a10, *vecs, lam_fp),
        search_bound(fbytes, diffs, positions, 10, rate))
    del b10, a10
    results["full_search"] = {
        "name": "full_search", "route": "cuda",
        "source": "hevc_tpu_torch/csrc/sad.cu",
        "replaces": "hevc_tpu/ops/me.py:84", "max_abs_err": e, "ms": ms,
        "plain_ms": pms, "bound_ms": bms, "bound_by": by,
        "library_ms": None, "queued_ms": q_ms, "deep": deep}
    log(f"  full_search 8-bit: kernel_ms {ms:.4f} (queued {q_ms:.4f}) "
        f"plain_ms {pms:.3f} bound_ms {bms:.4f} ({by})")
    return blks, areas


def cdist_ms(blks, areas, count, table):
    """The library yardstick of a SAD table: torch.cdist(x1, x2, p=1) in
    float32 over the first count blocks, 16 at a time. Each chunk's windows
    are unfolded before its timed calls (not timed), its result is checked
    equal to the kernel's table rows, and the measured times are summed."""
    k, total = 16, 0.0
    size = blks.shape[-1]
    for c in range(0, count, k):
        m = min(k, count - c)
        x1 = areas[c:c + m].to(torch.float32).unfold(1, size, 1).unfold(
            2, size, 1).reshape(m, -1, size * size).contiguous()
        x2 = blks[c:c + m].to(torch.float32).reshape(m, 1, size * size)
        fn = lambda: torch.cdist(x1, x2, p=1)  # noqa: E731
        got = fn()[:, :, 0]
        exp = table[c:c + m].reshape(m, -1).to(torch.float32)
        if int((got - exp).abs().max()) != 0:
            raise AssertionError(f"torch.cdist disagrees with the kernel's "
                                 f"table at blocks {c}..{c + m - 1}")
        total += cuda_ms(fn, 3)
        del x1, x2, got
    return total


def check_planes(orig, refp, lam_fp, rate, blks, areas, results):
    """The planes-in SAD entries at the 1080p shape (32x32 blocks, r = 64,
    pad 80: 1980 blocks in a bucket of 2048). No encoder path calls them;
    this is their path: counters reset, each entry point called once on the
    uint8 planes, and the counts read. Then each is held against its plain
    version, and again on the planes as int16 << 2 (10 bits). blks and
    areas are the same blocks and windows as int32 tensors (check_sad_tables
    cut them from the same planes): sad_table_planes' library yardstick is
    cdist over its n blocks of them, checked equal to its table."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd, sad
    dev = orig.device
    h, w = orig.shape
    size, r = 32, 64
    ny, nx = h // size, w // size
    nyx, n = 2 * r + 1, (h // size) * (w // size)
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=PAD)
    bits = runtime.upload(me_ssd.bits0_table(r), dev)
    runtime.reset_launches()
    tab_k = sad.sad_table_from_planes(refp, orig, **kw)
    idx_k = sad.me_from_planes(refp, orig, bits, lam_fp, **kw)
    torch.cuda.synchronize()
    path = dict(runtime.launches)
    runtime.reset_launches()
    bucket = tab_k.shape[0]
    log(f"  planes entry points ({ny}x{nx} = {n} blocks, bucket {bucket}): "
        f"launches {path}")
    tab_p = sad.sad_table_from_planes_plain(refp, orig, **kw)
    idx_p = sad.me_from_planes_plain(refp, orig, bits, lam_fp, **kw)
    torch.cuda.synchronize()
    e_tab, e_idx = max_abs_err(tab_k, tab_p), max_abs_err(idx_k, idx_p)
    log(f"  sad_table_planes: max_abs_err {e_tab}; me_planes: max_abs_err "
        f"{e_idx}")
    if e_tab != 0 or e_idx != 0:
        raise AssertionError("a planes kernel disagrees with its plain "
                             "version")
    del tab_p, idx_p
    refp16, orig16 = refp.to(torch.int16) << 2, orig.to(torch.int16) << 2
    diffs = float(n) * nyx * nyx * size * size
    for name, call, plain, out_bytes, replaces in (
            ("sad_table_planes", sad.sad_table_from_planes,
             sad.sad_table_from_planes_plain, tab_k.numel() * 4,
             "hevc_tpu/ops/sad_pallas.py:99"),
            ("me_planes",
             lambda a, b, **k: sad.me_from_planes(a, b, bits, lam_fp, **k),
             lambda a, b, **k: sad.me_from_planes_plain(a, b, bits, lam_fp,
                                                        **k),
             idx_k.numel() * 4 + bits.numel() * 4,
             "hevc_tpu/ops/sad_pallas.py:134")):
        if path[name] <= 0:
            raise AssertionError(f"{name} was never launched")
        fn = lambda: call(refp, orig, **kw)  # noqa: E731
        ms, q_ms = cuda_ms(fn, 3), cuda_ms(fn, 10, queued=True)
        pms = cuda_ms(lambda: plain(refp, orig, **kw), 1)
        plane_bytes = refp.numel() + orig.numel()
        bms, by = sad_bound(plane_bytes + out_bytes, diffs, 8, rate)
        deep = time_deep(
            name, lambda: call(refp16, orig16, **kw),
            lambda: plain(refp16, orig16, **kw),
            sad_bound(2 * plane_bytes + out_bytes, diffs, 10, rate))
        lib = (cdist_ms(blks, areas, n, tab_k)
               if name == "sad_table_planes" else None)
        results[name] = {
            "name": name, "route": "cuda",
            "source": "hevc_tpu_torch/csrc/sad.cu", "replaces": replaces,
            "launches": path[name], "max_abs_err": e_tab if name ==
            "sad_table_planes" else e_idx, "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "queued_ms": q_ms, "deep": deep}
        log(f"  {name} 8-bit: kernel_ms {ms:.4f} (queued {q_ms:.4f}) "
            f"plain_ms {pms:.3f} bound_ms {bms:.4f} ({by})"
            + (f" library_ms {lib:.4f} (torch.cdist p=1 over its {n} "
               f"blocks)" if lib else ""))


def profile_encodes(tmp, seed):
    """Phase 9: a 4-frame LDP (without and with the refine tables), a
    2-picture all-intra and a 9-frame RA-Main10 (the IDR and one GOP of
    eight, 10-bit) 1080p encode under
    torch.profiler with CUDA activity. Logs, per encode, every device
    activity by name (device ms in all, count) and the device's busy share
    of the encode's wall time (the union of the device intervals over the
    host clock around the encode)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for name, n, cfg, bd, env in (
            ("prof_ldp", 4, LDP_CFG, 8, {}),
            ("prof_ldp_refine", 4, LDP_CFG, 8, {"HEVC_TPU_ME_REFINE": "1"}),
            ("prof_intra", 2, INTRA_CFG, 8, {}),
            ("prof_ra10", N_RA, RA10_CFG, 10, {})):
        with env_set(env), profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
            _, secs, _, _ = encode(tmp, name, 1920, 1080, n, seed, "cuda",
                                   cfg=cfg, bit_depth=bd)
        del streams[name]
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not dev:
            log(f"  {name}: torch.profiler recorded no device time "
                f"({secs:.3f} s wall); busy share not measured")
            continue
        by_name = {}
        for e in dev:
            short = e.name.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            t = by_name.setdefault(short[:72], [0.0, 0])
            t[0] += (e.time_range.end - e.time_range.start) / 1e3
            t[1] += 1
        for k, (ms, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
            log(f"    {name} device {ms:.4f} ms x{cnt}: {k}")
        busy, end = 0.0, None
        for st, en in sorted((e.time_range.start, e.time_range.end)
                             for e in dev):
            if end is None or st > end:
                busy += en - st
                end = en
            elif en > end:
                busy += en - end
                end = en
        log(f"  {name}: {n} frames, {secs:.3f} s wall, device busy "
            f"{busy / 1e3:.3f} ms = {busy / 1e4 / secs:.4f} % of the wall "
            f"time")


def check_fallback_launches(launches, p_pictures):
    """The fallback inter path runs one fused full search a P picture and
    no launch of the table route (sad_table, sad_cost_argmin)."""
    if launches["full_search"] != p_pictures:
        raise AssertionError(f"full_search launched {launches['full_search']}"
                             f" times for {p_pictures} P pictures")
    for k in ("sad_table", "sad_cost_argmin"):
        if launches[k] != 0:
            raise AssertionError(f"{k} launched on the fallback path")


def encode_hd422(tmp, seed):
    """The fallback inter path at 1920x1080 8-bit 4:2:2: the IDR and one P
    picture on the card under torch.profiler (as phase 9 runs it). Logs
    the wall time, the full search's device time and its launches; phase
    8 decodes the stream."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from hevc_tpu_torch import runtime
    runtime.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stream, secs, _, _ = encode(tmp, "hd422", 1920, 1080, 2, seed, "cuda",
                                    chroma=422)
    launches = dict(runtime.launches)
    check_fallback_launches(launches, 1)
    fs = [e.time_range.end - e.time_range.start for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and "full_search_kernel" in e.name]
    dev_ms = (f"{sum(fs) / 1e3:.4f} ms device in {len(fs)} kernel(s)"
              if fs else "device time not measured (torch.profiler "
              "recorded no full_search_kernel)")
    log(f"  1920x1080 4:2:2, 2 pictures: {len(stream)} bytes md5 "
        f"{hashlib.md5(stream).hexdigest()}, {secs:.2f} s wall (under the "
        f"profiler); full search {dev_ms}; launches['full_search'] "
        f"{launches['full_search']}")


def encode(tmp, name, w, h, n, seed, device, chroma=420, recon=False,
           cfg=LDP_CFG, bit_depth=8, extra=(), fade=0.0):
    """One CLI encode (extra: more CLI arguments); returns (stream bytes,
    seconds, CLI stdout, luma planes). Every stream is kept in `streams`
    for the decode phase."""
    from hevc_tpu_torch.cli.encode import main
    clip = os.path.join(tmp, f"{name}.yuv")
    frames = write_clip(clip, w, h, n, seed, chroma, bit_depth, fade)
    out = os.path.join(tmp, f"{name}.bin")
    args = ["-c", cfg, "-i", clip, "-wdt", str(w), "-hgt", str(h),
            "-f", str(n), "-b", out]
    if chroma != 420:
        args.append(f"--InputChromaFormat={chroma}")
    if bit_depth != 8:
        args += [f"--InputBitDepth={bit_depth}",
                 f"--InternalBitDepth={bit_depth}"]
    if recon:
        args += ["-o", os.path.join(tmp, f"{name}_rec.yuv")]
    args += list(extra)
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(args, device=device)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{name}: encoder exited with {rc}")
    with open(out, "rb") as fh:
        stream = fh.read()
    streams[name] = (stream, n)
    return stream, secs, buf.getvalue(), frames


# name -> (stream bytes, picture count) of every encode of this run
streams = {}


def check_hd_encode(stream, secs, out, frames, tmp, name, md5_seed1, seed,
                    bit_depth=8):
    """Log and check a 1080p encode: md5 (against its anchor for --seed 1),
    start code, and finite recon PSNR above 25 dB."""
    from hevc_tpu_torch.utils.timing import timers
    ps = psnr_y(frames, os.path.join(tmp, f"{name}_rec.yuv"), 1920, 1080,
                bit_depth)
    fps_line = [ln for ln in out.splitlines() if "fps" in ln]
    md5 = hashlib.md5(stream).hexdigest()
    log(f"  {len(stream)} bytes, md5 {md5}"
        f", {secs:.2f} s incl. warm-up; CLI: {fps_line[-1].strip()}")
    log(f"  Y-PSNR per frame: {[round(float(p), 3) for p in ps]}")
    log(f"  host/device sections (s): {timers.summary()}")
    if not stream.startswith(b"\x00\x00\x00\x01"):
        raise AssertionError("stream does not start with a start code")
    if seed == 1 and md5_seed1 is not None and md5 != md5_seed1:
        raise AssertionError(f"{name} stream md5 {md5}, expected "
                             f"{md5_seed1} for --seed 1")
    if not all(np.isfinite(ps)) or min(ps) < 25.0:
        raise AssertionError(f"recon PSNR too low: {ps}")


@contextlib.contextmanager
def env_set(env):
    """Set environment variables for the duration of a block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def log_encode(name, env, stream, secs, out, sections, extra=""):
    """One line per encode: settings, md5, wall time, the CLI's frames/s
    and the host/device sections engine_host and me_device."""
    fps_line = [ln for ln in out.splitlines() if "fps" in ln]
    log(f"  {name} {env}: {len(stream)} bytes md5 "
        f"{hashlib.md5(stream).hexdigest()}, {secs:.2f} s incl. warm-up; "
        f"CLI: {fps_line[-1].strip() if fps_line else 'no fps line'}; "
        f"engine_host {sections.get('engine_host', 0.0)} s, me_device "
        f"{sections.get('me_device', 0.0)} s; {extra}")
    log(f"    sections (s): {sections}")


def psnr_y(frames, rec_path, w, h, bit_depth=8):
    """Luma PSNR of each recon picture against the source (the 8-bit planes
    write_clip returns, at bit_depth as it wrote them)."""
    rec = np.fromfile(rec_path, "<u2" if bit_depth > 8 else np.uint8)
    fsz = w * h * 3 // 2
    if rec.size != fsz * len(frames):
        raise AssertionError(f"recon holds {rec.size} samples, expected "
                             f"{fsz * len(frames)}")
    peak = (1 << bit_depth) - 1
    out = []
    for i, y in enumerate(frames):
        r = rec[i * fsz:i * fsz + w * h].reshape(h, w).astype(np.float64)
        src = deep_plane(y, bit_depth) if bit_depth > 8 else y
        mse = ((r - src) ** 2).mean()
        out.append(99.99 if mse == 0 else 10 * np.log10(peak ** 2 / mse))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.entropy import cabac
    from hevc_tpu_torch.utils.timing import timers

    results = {}
    tmp = tempfile.mkdtemp(prefix="hevc_chip_smoke_")
    try:
        with Phase("1 build"):
            shutil.rmtree(runtime.BUILD_DIR, ignore_errors=True)
            t0 = time.perf_counter()
            per = runtime.build_kernels()
            log(f"  kernel libraries (nvcc {', '.join(sorted(per))}): "
                f"{time.perf_counter() - t0:.2f} s "
                + " ".join(f"{k}={v:.2f}s" for k, v in sorted(per.items())))
            for name in per:
                with open(os.path.join(runtime.BUILD_DIR,
                                       f"{name}.log")) as fh:
                    for line in fh:
                        if "registers" in line or "spill" in line:
                            log(f"    {name}: {line.strip()}")
            check_sass()
            t0 = time.perf_counter()
            cabac.get_lib()
            log(f"  native library (make): {time.perf_counter() - t0:.2f} s")

        with Phase("2 kernels vs plain at 1080p shapes"):
            frames = write_clip(os.path.join(tmp, "k.yuv"), 1920, 1080, 2,
                                args.seed)
            check_kernels(frames, args.seed, results)
            torch.cuda.empty_cache()

        with Phase("3 encode 1920x1080 LDP-P on cuda"):
            runtime.reset_launches()
            timers.reset()
            timers.enabled = True
            stream, secs, out, frames = encode(
                tmp, "hd", 1920, 1080, N_FRAMES, args.seed, "cuda",
                recon=True)
            timers.enabled = False
            main_launches = dict(runtime.launches)
            check_hd_encode(stream, secs, out, frames, tmp, "hd",
                            HD_MD5_SEED1, args.seed)
            log(f"  launches: {main_launches}")
            for k in ("ssd_table", "argmin_two_pass", "box_energies"):
                if main_launches[k] <= 0:
                    raise AssertionError(f"{k} was never launched")
                results[k]["launches"] = main_launches[k]

        with Phase("3b encode 1920x1080 LDP-P with the refine tables on "
                   "cuda"):
            # off, on, on, off with the lookahead on the final references:
            # one stream; then on with the default pre-loop-filter one
            md5s = {}
            pf0 = {"HEVC_TPU_ME_PREFILTER_REF": "0"}
            for name, env in (
                    ("hd_pf0_off", dict(pf0, HEVC_TPU_ME_REFINE="0")),
                    ("hd_pf0_on", dict(pf0, HEVC_TPU_ME_REFINE="1")),
                    ("hd_pf0_on_b", dict(pf0, HEVC_TPU_ME_REFINE="1")),
                    ("hd_pf0_off_b", dict(pf0, HEVC_TPU_ME_REFINE="0")),
                    ("hd_refine", {"HEVC_TPU_ME_REFINE": "1"})):
                with env_set(env):
                    runtime.reset_launches()
                    timers.reset()
                    timers.enabled = True
                    stream, secs, out, _ = encode(
                        tmp, name, 1920, 1080, N_FRAMES, args.seed, "cuda")
                    timers.enabled = False
                n = runtime.launches["refine_tables"]
                md5s[name] = hashlib.md5(stream).hexdigest()
                log_encode(name, env, stream, secs, out, timers.summary(),
                           f"refine_tables launches {n}")
                if (n > 0) != (env["HEVC_TPU_ME_REFINE"] == "1"):
                    raise AssertionError(f"{name}: refine_tables launched "
                                         f"{n} times")
                if name == "hd_refine":
                    results["refine_tables"]["launches"] = n
            # the same bytes four times: phase 8 decodes one of them
            for name in ("hd_pf0_off", "hd_pf0_on_b", "hd_pf0_off_b"):
                del streams[name]
                if md5s[name] != md5s["hd_pf0_on"]:
                    raise AssertionError(
                        "the refine tables changed the stream with "
                        "HEVC_TPU_ME_PREFILTER_REF=0")

        with Phase("3c encode a 1920x1080 fade with WeightedPredP=1 on "
                   "cuda"):
            runtime.reset_launches()
            timers.reset()
            timers.enabled = True
            stream, secs, out, frames = encode(
                tmp, "hd_fade", 1920, 1080, N_FADE, args.seed, "cuda",
                recon=True, extra=["--WeightedPredP=1"], fade=FADE)
            timers.enabled = False
            n = runtime.launches["wp_apply"]
            check_hd_encode(stream, secs, out, frames, tmp, "hd_fade", None,
                            args.seed)
            log(f"  wp_apply launches {n} (a launch only where the analysis "
                f"chose weights)")
            if n <= 0:
                raise AssertionError("no weights chosen: wp_apply was never "
                                     "launched")
            results["wp_apply"]["launches"] = n

        with Phase("4 416x240 cuda vs cpu"):
            s_gpu, t_gpu, _, _ = encode(tmp, "cif_gpu", 416, 240, N_FRAMES,
                                        args.seed, "cuda")
            s_cpu, t_cpu, _, _ = encode(tmp, "cif_cpu", 416, 240, N_FRAMES,
                                        args.seed, "cpu")
            log(f"  cuda {len(s_gpu)} bytes md5 "
                f"{hashlib.md5(s_gpu).hexdigest()} {t_gpu:.2f} s; cpu "
                f"{len(s_cpu)} bytes md5 {hashlib.md5(s_cpu).hexdigest()} "
                f"{t_cpu:.2f} s")
            if s_gpu != s_cpu:
                raise AssertionError("cuda and cpu streams differ")

        with Phase("5 4:2:2 fallback inter path: 416x240 cuda vs cpu, "
                   "1920x1080 on cuda"):
            runtime.reset_launches()
            s422, t422, _, _ = encode(tmp, "cif422", 416, 240, 3, args.seed,
                                      "cuda", chroma=422)
            fb_launches = dict(runtime.launches)
            log(f"  {len(s422)} bytes md5 {hashlib.md5(s422).hexdigest()} "
                f"{t422:.2f} s; launches: {fb_launches}")
            check_fallback_launches(fb_launches, 2)
            results["full_search"]["launches"] = fb_launches["full_search"]
            # the same clip on the CPU, and at 10 bits (the float path of
            # the SAD sweep) on both: each pair byte-identical
            for bd, gpu in ((8, s422), (10, None)):
                tag = "" if bd == 8 else f"_{bd}"
                if gpu is None:
                    runtime.reset_launches()
                    gpu, t_gpu, _, _ = encode(tmp, f"cif422{tag}", 416, 240,
                                              3, args.seed, "cuda",
                                              chroma=422, bit_depth=bd)
                    check_fallback_launches(runtime.launches, 2)
                s_cpu, t_cpu, _, _ = encode(tmp, f"cif422{tag}_cpu", 416,
                                            240, 3, args.seed, "cpu",
                                            chroma=422, bit_depth=bd)
                log(f"  {bd}-bit 4:2:2: cuda {len(gpu)} bytes md5 "
                    f"{hashlib.md5(gpu).hexdigest()}; cpu {len(s_cpu)} bytes "
                    f"md5 {hashlib.md5(s_cpu).hexdigest()} {t_cpu:.2f} s")
                if gpu != s_cpu:
                    raise AssertionError(f"{bd}-bit 4:2:2 cuda and cpu "
                                         f"streams differ")
            encode_hd422(tmp, args.seed)

        with Phase("6 encode 1920x1080 all-intra on cuda"):
            runtime.reset_launches()
            timers.reset()
            timers.enabled = True
            stream, secs, out, frames = encode(
                tmp, "hd_intra", 1920, 1080, N_INTRA, args.seed, "cuda",
                recon=True, cfg=INTRA_CFG)
            timers.enabled = False
            intra_launches = dict(runtime.launches)
            check_hd_encode(stream, secs, out, frames, tmp, "hd_intra",
                            HD_INTRA_MD5_SEED1, args.seed)
            log(f"  launches: {intra_launches}")
            if intra_launches["intra_screen"] < N_INTRA:
                raise AssertionError(
                    f"intra_screen launched {intra_launches['intra_screen']}"
                    f" times for {N_INTRA} pictures")
            results["intra_screen"]["launches"] = \
                intra_launches["intra_screen"]

        with Phase("7 416x240 all-intra cuda vs cpu"):
            s_gpu, t_gpu, _, _ = encode(tmp, "cif_intra_gpu", 416, 240,
                                        N_INTRA, args.seed, "cuda",
                                        cfg=INTRA_CFG)
            s_cpu, t_cpu, _, _ = encode(tmp, "cif_intra_cpu", 416, 240,
                                        N_INTRA, args.seed, "cpu",
                                        cfg=INTRA_CFG)
            log(f"  cuda {len(s_gpu)} bytes md5 "
                f"{hashlib.md5(s_gpu).hexdigest()} {t_gpu:.2f} s; cpu "
                f"{len(s_cpu)} bytes md5 {hashlib.md5(s_cpu).hexdigest()} "
                f"{t_cpu:.2f} s")
            if s_gpu != s_cpu:
                raise AssertionError("all-intra cuda and cpu streams differ")

        with Phase("7b encode 1920x1080 random access on cuda, Main and "
                   "Main10"):
            deep = ("ssd_table_deep", "box_energies_deep")
            for name, cfg, bd, md5 in (
                    ("hd_ra", RA_CFG, 8, HD_RA_MD5_SEED1),
                    ("hd_ra10", RA10_CFG, 10, HD_RA10_MD5_SEED1)):
                runtime.reset_launches()
                timers.reset()
                timers.enabled = True
                stream, secs, out, frames = encode(
                    tmp, name, 1920, 1080, N_RA, args.seed, "cuda",
                    recon=True, cfg=cfg, bit_depth=bd)
                timers.enabled = False
                ra_launches = dict(runtime.launches)
                log(f"  {name} ({bd}-bit):")
                check_hd_encode(stream, secs, out, frames, tmp, name, md5,
                                args.seed, bit_depth=bd)
                log(f"  launches: {ra_launches}")
                on = deep if bd > 8 else ("ssd_table", "box_energies")
                off = ("ssd_table", "box_energies") if bd > 8 else deep
                for k in on + ("argmin_two_pass",):
                    if ra_launches[k] <= 0:
                        raise AssertionError(f"{name}: {k} was never "
                                             f"launched")
                for k in off:
                    if ra_launches[k] != 0:
                        raise AssertionError(f"{name}: {k} launched at "
                                             f"{bd} bits")
                if bd > 8:
                    for k in deep:
                        results[k]["launches"] = ra_launches[k]

        with Phase("7c 416x240 RA-Main10 and low-delay B cuda vs cpu"):
            for name, cfg, bd in (("cif_ra10", RA10_CFG, 10),
                                  ("cif_ldb", LDB_CFG, 8)):
                runtime.reset_launches()
                s_gpu, t_gpu, _, _ = encode(tmp, f"{name}_gpu", 416, 240,
                                            N_RA, args.seed, "cuda", cfg=cfg,
                                            bit_depth=bd)
                gpu_launches = dict(runtime.launches)
                s_cpu, t_cpu, _, _ = encode(tmp, f"{name}_cpu", 416, 240,
                                            N_RA, args.seed, "cpu", cfg=cfg,
                                            bit_depth=bd)
                log(f"  {name}: cuda {len(s_gpu)} bytes md5 "
                    f"{hashlib.md5(s_gpu).hexdigest()} {t_gpu:.2f} s; cpu "
                    f"{len(s_cpu)} bytes md5 {hashlib.md5(s_cpu).hexdigest()}"
                    f" {t_cpu:.2f} s; cuda launches {gpu_launches}")
                if s_gpu != s_cpu:
                    raise AssertionError(f"{name}: cuda and cpu streams "
                                         f"differ")
                key = "ssd_table_deep" if bd > 8 else "ssd_table"
                if gpu_launches[key] <= 0:
                    raise AssertionError(f"{name}: {key} was never launched")

        with Phase("7d 416x240 weighted prediction and refine tables cuda "
                   "vs cpu"):
            for name, cfg, bd, n, extra, fade, env, key in (
                    ("cif_wp", LDP_CFG, 8, N_FRAMES, ["--WeightedPredP=1"],
                     FADE, {}, "wp_apply"),
                    ("cif_wp_ra10", RA10_CFG, 10, N_RA,
                     ["--WeightedPredP=1", "--WeightedPredB=1"], FADE, {},
                     "wp_apply"),
                    ("cif_refine", LDP_CFG, 8, N_FRAMES, [], 0.0,
                     {"HEVC_TPU_ME_REFINE": "1"}, "refine_tables")):
                kw = dict(cfg=cfg, bit_depth=bd, extra=extra, fade=fade)
                with env_set(env):
                    runtime.reset_launches()
                    s_gpu, t_gpu, _, _ = encode(tmp, f"{name}_gpu", 416, 240,
                                                n, args.seed, "cuda", **kw)
                    launched = runtime.launches[key]
                    s_cpu, t_cpu, _, _ = encode(tmp, f"{name}_cpu", 416, 240,
                                                n, args.seed, "cpu", **kw)
                log(f"  {name}: cuda {len(s_gpu)} bytes md5 "
                    f"{hashlib.md5(s_gpu).hexdigest()} {t_gpu:.2f} s; cpu "
                    f"{len(s_cpu)} bytes md5 {hashlib.md5(s_cpu).hexdigest()}"
                    f" {t_cpu:.2f} s; cuda {key} launches {launched}")
                if s_gpu != s_cpu:
                    raise AssertionError(f"{name}: cuda and cpu streams "
                                         f"differ")
                if launched <= 0:
                    raise AssertionError(f"{name}: {key} was never launched")

        with Phase("8 decode every stream with the port's decoder"):
            from hevc_tpu_torch.decoder.top import DecoderTop
            for name, (data, n) in streams.items():
                dec = DecoderTop()
                t0 = time.perf_counter()
                pics = sum(1 for _ in dec.decode_stream(data))
                secs = time.perf_counter() - t0
                ok = sum(st == "OK" for st in dec.hash_status)
                log(f"  {name}: {pics} pictures, {ok} hashes OK, "
                    f"{secs:.2f} s")
                if pics != n or dec.hash_status != ["OK"] * n:
                    raise AssertionError(
                        f"{name}: decoded {pics} of {n} pictures, hash "
                        f"status {dec.hash_status}")

        with Phase("9 device busy share under torch.profiler"):
            profile_encodes(tmp, args.seed)

        with Phase("10 card"):
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60)
            if smi.returncode != 0 or not smi.stdout.strip():
                raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
            card = smi.stdout.strip().splitlines()[0]
            log(f"  torch {torch.__version__} cuda {torch.version.cuda}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    order = ["ssd_table", "argmin_two_pass", "box_energies", "sad_table",
             "sad_cost_argmin", "full_search", "sad_table_planes",
             "me_planes", "intra_screen", "ssd_table_deep",
             "box_energies_deep", "wp_apply", "refine_tables"]
    kernels = [results[k] for k in order]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
