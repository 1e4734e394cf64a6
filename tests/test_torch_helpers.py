"""Shared pieces of the hevc_tpu_torch parity tests (tests/test_torch_*.py);
this module holds no tests itself.

The port is held to the JAX package on the CPU: inputs are made from a
numpy seed, go through both packages, and every comparison is exact.
"""
import contextlib
import fcntl
import hashlib
import importlib.util
import os
import shutil
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_DIR = os.path.join(REPO, "hevc_tpu_torch", "cfg")
LDP_CFG = os.path.join(CFG_DIR, "encoder_lowdelay_P_main.cfg")
INTRA_CFG = os.path.join(CFG_DIR, "encoder_intra_main.cfg")
# hevc_tpu's native sources and the private builds of them the port's
# tests load (never the library make writes beside the sources)
REF_NATIVE_DIR = os.path.join(REPO, "hevc_tpu", "entropy", "native")
REF_NATIVE_BUILDS = os.path.join(REPO, ".test_build", "hevc_tpu_native")


def reference_native_lib():
    """Path of hevc_tpu's native library, built once into a private
    directory keyed by a hash of its sources and Makefile.

    hevc_tpu's loader runs `make` beside its sources with no lock, so test
    workers that load it at the same moment on a fresh checkout can read a
    half-linked library. Here the sources are copied into a directory of
    their own and built under an exclusive file lock; the finished
    directory appears by one rename."""
    names = sorted(f for f in os.listdir(REF_NATIVE_DIR)
                   if f.endswith((".cpp", ".h")) or f == "Makefile")
    digest = hashlib.sha256()
    for name in names:
        digest.update(name.encode())
        with open(os.path.join(REF_NATIVE_DIR, name), "rb") as fh:
            digest.update(fh.read())
    out = os.path.join(REF_NATIVE_BUILDS, digest.hexdigest()[:16])
    lib = os.path.join(out, "libhevc_entropy.so")
    os.makedirs(REF_NATIVE_BUILDS, exist_ok=True)
    with open(os.path.join(REF_NATIVE_BUILDS, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib):
            tmp = out + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for name in names:
                shutil.copy(os.path.join(REF_NATIVE_DIR, name), tmp)
            subprocess.run(["make", "-s", f"-j{os.cpu_count() or 1}",
                            "libhevc_entropy.so"], cwd=tmp, check=True)
            os.replace(tmp, out)
        # newer than every source, so hevc_tpu's loader never runs make
        os.utime(lib)
    return lib


@pytest.fixture(autouse=True, scope="module")
def private_reference_native():
    """Point hevc_tpu's loader at reference_native_lib() for one test
    module (import this fixture into every module that runs hevc_tpu's
    encoder or decoder), and forget the libraries it loaded before."""
    from hevc_tpu.entropy import cabac
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cabac, "_LIB_PATH", reference_native_lib())
        mp.setattr(cabac, "_libs", {})
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run one test module's torch CPU work on a single thread, and restore
    the thread count afterwards (import this fixture into the module).
    pytest-xdist workers share the machine's cores; torch's OpenMP threads
    in each of them oversubscribe it, and the many small tensor ops of the
    kernels' plain versions then wait at every OpenMP barrier: with six
    workers on eight cores, tests/test_torch_me_refine.py ran 25 times
    slower than alone."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def no_jax_cache_writes():
    """Keep JAX reference calls from writing the persistent compile cache
    (hevc_tpu points it into the repository): a minimum compile time of
    1e9 s means no compile qualifies. JAX reads the setting at every cache
    write; the old value is restored afterwards."""
    import jax
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    try:
        yield
    finally:
        jax.config.update(key, old)


def moving_frames(n, w, h, chroma=420, seed=5):
    """n frames [Y, Cb, Cr] (uint8) of smooth random texture panning by
    (3, 2) samples per frame: real motion, so the search has work to do."""
    from scipy.ndimage import uniform_filter
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 3 * n + 8, w + 3 * n + 8))
    base = uniform_filter(base.astype(np.float32), 5).astype(np.uint8)
    out = []
    for t in range(n):
        y = base[2 * t:2 * t + h, 3 * t:3 * t + w].copy()
        if chroma == 420:
            u, v = y[::2, ::2], y[1::2, ::2]
        elif chroma == 422:
            u, v = y[:, ::2], y[:, 1::2]
        else:
            raise ValueError(chroma)
        out.append([y, (u // 2 + 32).astype(np.uint8),
                    (v // 2 + 48).astype(np.uint8)])
    return out


def at_depth(p, depth):
    """A uint8 plane at `depth` bits: itself at 8, above it int16 samples
    s << k | s & (2^k - 1), k = depth - 8 (the low bits repeat the high
    ones, as chip_smoke.py writes its clips)."""
    k = depth - 8
    if not k:
        return p
    return ((p.astype(np.int16) << k) | (p & ((1 << k) - 1))).astype(np.int16)


# Sample ranges the SAD-table kernel branches on: [0, 255] takes its 8-bit
# path, 10-14 bits its float path at 32 x 32 (h * w * max < 2^24), 16 bits
# at 32 x 32 and anything negative its int32 path; "wrap" sums overflow
# int32. "mixed" gives every block of one launch another range.
SAD_RANGES = {"8bit": (0, 255), "10bit": (0, 1023), "12bit": (0, 4095),
              "14bit": (0, 16383), "16bit": (0, 65535),
              "wrap": (-(1 << 28), 1 << 28)}
SAD_KINDS = list(SAD_RANGES) + ["mixed"]
# (h, w, ny, nx): non-square blocks and searches, 64 x 64 at R = 1 .. 4
SAD_SHAPES = [(16, 16, 5, 5), (8, 16, 3, 7), (16, 8, 7, 3), (32, 32, 7, 5),
              (64, 64, 3, 3), (64, 64, 5, 5), (64, 64, 7, 7), (64, 64, 9, 9)]


def sad_range_case(kind, n, h, w, ny, nx, seed):
    """blks [n, h, w] and areas [n, h+ny-1, w+nx-1] int32 in one of
    SAD_RANGES: block 0 is the range's top against an area of its bottom
    (the largest SAD it allows), every other block random with the
    range's two ends at its first and last samples."""
    rng = np.random.default_rng(seed)
    names = list(SAD_RANGES)
    blks = np.empty((n, h, w), np.int32)
    areas = np.empty((n, h + ny - 1, w + nx - 1), np.int32)
    for k in range(n):
        lo, hi = SAD_RANGES[names[k % len(names)] if kind == "mixed"
                            else kind]
        if k == 0:
            blks[k], areas[k] = hi, lo
            continue
        for a in (blks[k], areas[k]):
            a[...] = rng.integers(lo, hi + 1, a.shape)
            a.flat[0], a.flat[-1] = lo, hi
    return blks, areas


# the full search's kinds: every SAD_KINDS range, and "flat" (every sample
# 100: every offset has SAD 0 and ties wherever the rates tie)
SEARCH_KINDS = SAD_KINDS + ["flat"]
# lam_fp of the cost tests: none (cost = sad), the encoder's order of
# magnitude, and one whose product with the rate bits wraps in int32
SEARCH_LAMS = [0, 40000, (1 << 28) + 4321]


def search_case(kind, n, h, w, ny, nx, seed, padding=0):
    """Inputs of a full search: sad_range_case's n blocks and areas (or
    "flat" ones) followed by `padding` all-zero rows, as the encoder pads
    to its bucket, and per-block mv_min_y, mv_min_x, pred_qy, pred_qx
    [n + padding] int32 that are not zero and differ from block to
    block."""
    if kind == "flat":
        blks = np.full((n, h, w), 100, np.int32)
        areas = np.full((n, h + ny - 1, w + nx - 1), 100, np.int32)
    else:
        blks, areas = sad_range_case(kind, n, h, w, ny, nx, seed)
    blks = np.concatenate([blks, np.zeros((padding, h, w), np.int32)])
    areas = np.concatenate([areas, np.zeros((padding,) + areas.shape[1:],
                                            np.int32)])
    rng = np.random.default_rng(seed + 1)
    m = n + padding
    vecs = [(-(ny // 2) + rng.integers(-3, 4, m)).astype(np.int32),
            (-(nx // 2) + rng.integers(-3, 4, m)).astype(np.int32)]
    vecs += [rng.choice(np.r_[-41:0, 1:42], m).astype(np.int32)
             for _ in range(2)]
    return (blks, areas, *vecs)


def cost_table(kind, n, ny, nx, seed):
    """An int32 SAD table [n, ny, nx] for the cost + argmin alone: "random"
    SADs below 2^20, "flat" (all 0: ties everywhere the rates tie), "huge"
    (within 64 of INT32_MAX, so that adding the rate wraps)."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        return np.zeros((n, ny, nx), np.int32)
    lo, hi = {"random": (0, 1 << 20),
              "huge": ((1 << 31) - 64, (1 << 31) - 1)}[kind]
    return rng.integers(lo, hi, (n, ny, nx), endpoint=True).astype(np.int32)


def planes_case(case, size, r, ny, nx, pad, seed):
    """ref_padded and orig for the planes-in SAD entries, each as a larger
    array and the (row, column, height, width) of the view into it:
    "u8_view" uint8 views that start at an odd column and have an odd row
    stride (every window starts at another byte offset); "i16_10bit" and
    "i16_15bit" whole int16 planes of 10 and 15-bit samples."""
    h, w = ny * size + 3, nx * size + 5
    rng = np.random.default_rng(seed)
    top = {"u8_view": 256, "i16_10bit": 1 << 10, "i16_15bit": 1 << 15}[case]
    dtype = np.uint8 if case == "u8_view" else np.int16
    out = []
    for (hh, ww), (y, x) in (((h + 2 * pad, w + 2 * pad), (1, 3)),
                             ((h, w), (2, 1))):
        if case != "u8_view":
            y = x = 0
            shape = (hh, ww)
        else:
            shape = (hh + y + 1, (ww + x + 2) | 1)   # odd row stride
        big = rng.integers(0, top, shape).astype(dtype)
        out.append((big, (y, x, hh, ww)))
    return out


def textured_frames(n, w, h, seed=1, chroma=420):
    """chip_smoke.py's content: noisy texture panning under a moving
    textured square (more residual per block than moving_frames)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.clip_frames(w, h, n, seed, chroma)
