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


def textured_frames(n, w, h, seed=1, chroma=420):
    """chip_smoke.py's content: noisy texture panning under a moving
    textured square (more residual per block than moving_frames)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.clip_frames(w, h, n, seed, chroma)
