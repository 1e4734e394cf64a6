"""Device selection, the CUDA kernel library, launch counters and readbacks.

The kernels live in ``csrc/*.cu``, one shared library per source file. At
first use every stale source is compiled by its own ``nvcc`` process, all
started together, into ``_build/lib<name>.so`` (a plain C interface, loaded
with ctypes). Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; :func:`check` raises when that is not 0.

``launches`` holds one plain integer per kernel. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels
the encoder really went through.

:class:`Readback` takes the place of JAX's asynchronous dispatch plus
``copy_to_host_async``: it starts a device-to-host copy into pinned memory
right behind the kernels that produce the data and records a CUDA event;
``result()`` waits on that event only.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from .utils.timing import timers

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# kernel name -> launches since the last reset()
launches: dict = {"sad_table": 0, "sad_cost_argmin": 0, "full_search": 0,
                  "ssd_table": 0, "argmin_two_pass": 0, "box_energies": 0,
                  "ssd_table_deep": 0, "box_energies_deep": 0,
                  "sad_table_planes": 0, "me_planes": 0, "intra_screen": 0,
                  "wp_apply": 0, "refine_tables": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of every entry point, by library
_SIGNATURES = {
    "sad": {
        "hevc_sad_table": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
        "hevc_sad_cost_argmin": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _P, _P, _P, _P, _P],
        "hevc_full_search": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P, _P, _P, _P, _P],
        "hevc_sad_table_planes": [_P, _L, _P, _L, _I, _P, _I, _I, _I, _I,
                                  _I, _I, _P],
        "hevc_me_planes": [_P, _L, _P, _L, _I, _P, _I, _P, _I, _I, _I, _I,
                           _I, _I, _P],
        "hevc_vabsdiff4_probe": [_P, _I, _I, _P],
    },
    "me_ssd": {
        "hevc_ssd_table": [_P, _L, _P, _L, _P, _L, _P, _I, _I, _I, _I,
                           _P],
        "hevc_argmin_two_pass": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
        "hevc_box_energies": [_P, _L, _I, _I, _I, _P, _L, _P],
        "hevc_ssd_table_deep": [_P, _L, _P, _L, _P, _L, _P, _I, _I, _I, _I,
                                _I, _I, _P],
        "hevc_ssd_table_deep_stage": [_P, _L, _P, _L, _P, _L, _P, _I, _I, _I,
                                      _I, _I, _I, _P],
        "hevc_box_energies_deep": [_P, _L, _I, _I, _I, _I, _I, _P, _L, _P],
        "hevc_box_energies_deep32": [_P, _L, _I, _I, _I, _I, _I, _P, _L,
                                     _P],
        "hevc_ssd_table_deep32": [_P, _L, _P, _L, _P, _L, _P, _I, _I, _I,
                                  _I, _I, _I, _P],
        "hevc_ssd_table_deep32_stage": [_P, _L, _P, _L, _P, _L, _P, _I, _I,
                                        _I, _I, _I, _I, _P],
        "hevc_mma_probe": [_P, _I, _I, _P],
    },
    "me_refine": {
        "hevc_wp_apply_multi": [_P, _I, _I, _I, _P],
        "hevc_refine_tables": [_P, _L, _P, _L, _I, _I, _I, _P, _I, _I, _I,
                               _I, _I, _I, _P, _P, _P],
        "hevc_refine_tables_half": [_P, _L, _P, _L, _I, _I, _I, _P, _I, _I,
                                    _I, _I, _I, _I, _P, _P, _P],
        "hevc_refine_tables_smem": [_I, _I],
    },
    "intra_screen": {
        "hevc_intra_screen": [_P, _L, _I, _I, _P, _I, _I, _I, _I, _I, _P,
                              _P, _P],
        "hevc_intra_screen32": [_P, _L, _I, _I, _P, _I, _I, _I, _I, _I, _P,
                                _P, _P],
    },
}
_libs: dict = {}


def resolve_device(device="cuda") -> torch.device:
    """torch.device for an entry point's ``device`` argument. Asking for a
    card where none is present raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is false")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with nvcc from the CUDA toolkit")
    return path


def build_kernels() -> dict:
    """Compile every stale ``csrc/*.cu`` into ``_build/lib<name>.so``, one
    nvcc process per source, all running at once. Returns {name: seconds
    of that build, or 0.0 when it was up to date}. Holds a file lock so
    concurrent processes never link the same library twice."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    headers = [os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
               if f.endswith(".cuh")]
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        procs = {}
        for name in srcs:
            src = os.path.join(CSRC_DIR, name + ".cu")
            out = os.path.join(BUILD_DIR, f"lib{name}.so")
            newest = max(os.path.getmtime(p) for p in [src] + headers)
            if os.path.exists(out) and os.path.getmtime(out) >= newest:
                continue
            log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
            procs[name] = (subprocess.Popen(
                [_nvcc()] + NVCC_FLAGS + ["-I", CSRC_DIR, "-o",
                                          out + ".tmp", src],
                stdout=log, stderr=subprocess.STDOUT), log,
                time.perf_counter(), out)
        secs = {name: 0.0 for name in srcs}
        failed = []
        for name, (proc, log, t0, out) in procs.items():
            rc = proc.wait()
            secs[name] = time.perf_counter() - t0
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                os.replace(out + ".tmp", out)
        if failed:
            msgs = []
            for name in failed:
                with open(os.path.join(BUILD_DIR, f"{name}.log")) as fh:
                    msgs.append(f"--- {name}.cu ---\n{fh.read()}")
            raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return secs


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``lib<name>.so``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_kernels()
        lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.hevc_kernel_error_string.argtypes = [ctypes.c_int]
        lib.hevc_kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise when a launch reported a CUDA error; count it otherwise."""
    if rc != 0:
        msg = lib.hevc_kernel_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")
    launches[kernel] += 1


def stream_of(t: torch.Tensor) -> int:
    """The raw cudaStream_t of the current stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, dtype: torch.dtype, name: str,
            contiguous: bool = True) -> None:
    """Argument check of a kernel wrapper: a CUDA tensor of the given
    dtype (and, by default, contiguous)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on the device (a copy on both devices, so the
    caller may reuse its array). Every host-to-device copy of the encode
    path goes through here; the `h2d_bytes` counter of utils.timing sums
    their sizes."""
    a = np.ascontiguousarray(a)
    timers.add("h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device, copy=True)


class Readback:
    """A device tensor's copy to the host, started at construction.

    On a card the copy goes into pinned memory behind the work already
    queued on the current stream and an event marks its end; ``result()``
    waits on that event only, so the host keeps working while the device
    computes. On the CPU the tensor is simply held."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t
            self._event = None

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
