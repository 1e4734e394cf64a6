"""The host CU engine's exact RDOQ (entropy/native/syntax.cpp rdoq_quant:
one instance per TB size, rates from an RdoqRates built once per set of
context states), through its test-only entry hevc_rdoq_quant, equal level
for level to hevc_tpu's rdoq_quant on the same context states
(hevctpu::ContextSet::init of the reference's native library, called
through its exported C++ symbols). Every TB size, component, scan and
slice type; QPs from high to low; 8 and 10 bits from the standard
libraries and 16 from the high-bit-depth ones; flat and non-flat scaling
matrices; sparse, dense and extreme (+-32767) blocks, which reach rice
escapes and coefficient-group zeroing; and coefficients halfway between
two dequantised levels under lambda 0, where only the order of the
comparisons decides."""
import ctypes
import os

import numpy as np
import pytest

from hevc_tpu_torch.entropy.cabac import get_lib
from test_torch_helpers import (REF_HBD_LIB, one_torch_thread,  # noqa: F401
                                reference_native_lib)

# (log2, scan): the mode-dependent scans exist at 4x4 and 8x8
SHAPES = [(2, 0), (2, 1), (2, 2), (3, 0), (3, 1), (3, 2), (4, 0), (5, 0)]
QPS = [22, 32, 37, 4]
Q_SCALE = [26214, 23302, 20560, 18396, 16384, 14564]
IQ_SCALE = [40, 45, 51, 57, 64, 72]
CONTEXT_SET_BYTES = 4096  # more than the reference's sizeof(ContextSet)

_INIT = "_ZN7hevctpu10ContextSet4initEii"
_RDOQ = "_ZN7hevctpu10rdoq_quantERKNS_10ContextSetEPKiPiiiiiidS4_"
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_refs = {}


def _reference(pel32):
    if pel32 not in _refs:
        lib = reference_native_lib()
        if pel32:
            lib = os.path.join(os.path.dirname(lib), REF_HBD_LIB)
        ref = ctypes.CDLL(lib)
        getattr(ref, _INIT).argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
        getattr(ref, _RDOQ).argtypes = (
            [ctypes.c_void_p, _i32p, _i32p] + [ctypes.c_int] * 5
            + [ctypes.c_double, ctypes.c_void_p])
        getattr(ref, _RDOQ).restype = ctypes.c_int
        _refs[pel32] = ref
    return _refs[pel32]


def _port(pel32):
    lib = get_lib(pel32)
    lib.hevc_rdoq_quant.argtypes = (
        [ctypes.c_int] * 7 + [ctypes.c_double, _i32p, ctypes.c_void_p,
                              _i32p])
    lib.hevc_rdoq_quant.restype = ctypes.c_int
    return lib


def _quant(qp, bd, log2):
    """The quantiser step in coefficient units, and the dequantiser of a
    flat matrix (the engine's integers)."""
    qpp = qp + 6 * (bd - 8)
    qbits = 14 + qpp // 6 + 15 - bd - log2
    bd_shift = bd + log2 - 5
    iqs = IQ_SCALE[qpp % 6] << (qpp // 6)

    def deq(level):
        return min(32767, (level * 16 * iqs + (1 << (bd_shift - 1)))
                   >> bd_shift)

    def maxlev(c):
        return (c * Q_SCALE[qpp % 6] + (1 << (qbits - 1))) >> qbits

    return (1 << qbits) / Q_SCALE[qpp % 6], deq, maxlev


def _blocks(rng, n, qp, bd, log2):
    step, deq, maxlev = _quant(qp, bd, log2)
    i, j = np.indices((n, n))
    decay = np.exp(-(i + j) / max(1.0, n / 3))
    out = []
    for scale in (0.4, 1.0, 2.5, 8.0):  # dense, levels fading with frequency
        out.append(rng.laplace(0, scale * step, (n, n)) * decay)
    for k in (1, 3, n):  # sparse
        b = np.zeros(n * n)
        b[rng.choice(n * n, k, replace=False)] = (
            rng.choice([-1, 1], k) * step * rng.uniform(0.4, 4.0, k))
        out.append(b.reshape(n, n))
    # a low-frequency block with isolated high-frequency coefficients: the
    # groups between them are worth zeroing
    b = rng.laplace(0, 2 * step, (n, n)) * (i + j < 3)
    b[n - 1, n - 1] = 1.2 * step
    b[n // 2, n - 1] = -1.6 * step
    out.append(b)
    # extremes: rice escapes, the dequantiser's clip
    out.append(np.full((n, n), 32767.0))
    out.append(rng.choice([-32767.0, 32767.0], (n, n)))
    out.append(rng.uniform(-32767, 32767, (n, n)))
    b = np.zeros((n, n))
    b[0, 0], b[n - 1, n - 1] = 32767, -32767
    out.append(b)
    # halfway between two dequantised levels (ties under lambda 0)
    mids = [c for c in ((deq(lv) + deq(lv - 1)) // 2 for lv in range(1, 9))
            if 0 < c <= 32767 and maxlev(c) >= 1]
    if mids:
        b = np.zeros(n * n)
        pos = rng.choice(n * n, min(n * n, 2 * len(mids)), replace=False)
        b[pos] = rng.choice([-1, 1], len(pos)) * np.resize(mids, len(pos))
        out.append(b.reshape(n, n))
    return [np.clip(np.rint(b), -32768, 32767).astype(np.int32) for b in out]


@pytest.mark.parametrize("bd", [8, 10, 16])
@pytest.mark.parametrize("slice_type", [0, 1, 2], ids=["B", "P", "I"])
@pytest.mark.parametrize("c_idx", [0, 1, 2])
@pytest.mark.parametrize("log2,scan", SHAPES,
                         ids=[f"{4 << (lg - 2)}s{s}" for lg, s in SHAPES])
def test_native_rdoq_equals_reference(log2, scan, c_idx, slice_type, bd):
    pel32 = bd > 14
    port, ref = _port(pel32), _reference(pel32)
    n = 1 << log2
    rng = np.random.default_rng(
        [log2, scan, c_idx, slice_type, bd])
    ctx = ctypes.create_string_buffer(CONTEXT_SET_BYTES)
    matrices = [None, np.ascontiguousarray(
        rng.integers(6, 120, n * n), np.int32)]
    calls = 0
    for qp in QPS:
        init_qp = max(qp, 0)
        getattr(ref, _INIT)(ctx, slice_type, init_qp)
        hm = 0.57 * 2.0 ** ((qp - 12) / 3)
        for lam in (hm, hm / 3, 0.0, 1.0):
            for smat in matrices:
                sp = None if smat is None else smat.ctypes.data
                for block in _blocks(rng, n, qp, bd, log2):
                    got = np.full(n * n, 7, np.int32)
                    want = np.full(n * n, 7, np.int32)
                    nz = port.hevc_rdoq_quant(slice_type, init_qp, log2,
                                              c_idx, scan, qp, bd, lam,
                                              block.ravel(), sp, got)
                    ref_nz = getattr(ref, _RDOQ)(ctx, block.ravel(), want,
                                                 log2, c_idx, scan, qp, bd,
                                                 lam, sp)
                    np.testing.assert_array_equal(
                        got, want, err_msg=f"qp {qp} lambda {lam} "
                        f"smat {smat is not None}")
                    assert nz == ref_nz == np.count_nonzero(got)
                    calls += 1
    assert calls > 0
