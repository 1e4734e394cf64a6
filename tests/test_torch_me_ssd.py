"""hevc_tpu_torch.ops.me_ssd against hevc_tpu.ops.me_mxu: the SSD table,
the two-pass argmin and the multi-reference two-grid search, each held to
the JAX programs run on JAX-CPU and to the numpy twin me_grid_ssd_np.
Exact integer equality throughout; the flat frames make every SSD equal,
so the argmins are decided by ties (first minimum)."""
import functools

import jax
import numpy as np
import pytest
import torch

from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.ops import me_ssd
from test_torch_helpers import moving_frames, no_jax_cache_writes
from test_torch_helpers import one_torch_thread  # noqa: F401

PAD = 80
W, H = 128, 96
LAM_FP = 120000


def _planes(kind):
    if kind == "moving":
        f = moving_frames(4, W, H, seed=7)
        return f[3][0], [f[2][0], f[1][0], f[0][0]]
    if kind == "flat":
        return (np.full((H, W), 128, np.uint8),
                [np.full((H, W), 128, np.uint8)] * 3)
    # flat source against textured references: ties in pass 2 only
    f = moving_frames(3, W, H, seed=3)
    return np.full((H, W), 90, np.uint8), [f[0][0], f[1][0], f[2][0]]


def _roi(refp, size, r, ny, nx):
    aw = 2 * r + size
    return refp[PAD - r:PAD - r + (ny - 1) * size + aw,
                PAD - r:PAD - r + (nx - 1) * size + aw]


@pytest.mark.parametrize("kind", ["moving", "flat", "flat_src"])
@pytest.mark.parametrize("size,r", [(32, 8), (16, 8)])
def test_ssd_table_and_argmin_match_jax(kind, size, r):
    orig, refs = _planes(kind)
    refp = np.pad(refs[0], PAD, mode="edge")
    ny, nx = H // size, W // size
    roi = _roi(refp, size, r, ny, nx)
    lam_q8 = me_mxu.lam_q8_of(LAM_FP)
    bits0 = me_mxu.bits0_table(r)
    with no_jax_cache_writes():
        ssd_j = np.array(jax.jit(functools.partial(
            me_mxu._ssd_table, size=size, r=r, ny=ny, nx=nx))(roi, orig))
        idx_j = np.asarray(jax.jit(functools.partial(
            me_mxu._argmin_two_pass, r=r, ny=ny, nx=nx))(
                ssd_j, bits0, np.int32(lam_q8)))
    ssd_t = me_ssd._ssd_table(torch.from_numpy(roi), torch.from_numpy(orig),
                              size=size, r=r, ny=ny, nx=nx)
    np.testing.assert_array_equal(ssd_t.numpy(), ssd_j)
    idx_t = me_ssd._argmin_two_pass(torch.from_numpy(ssd_j),
                                    torch.from_numpy(bits0), lam_q8, r=r,
                                    ny=ny, nx=nx, size=size)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)


@pytest.mark.parametrize("kind", ["moving", "flat", "flat_src"])
def test_me_grids_multi2_matches_jax_and_numpy(kind):
    """Three references (the JAX side pads them to four), both grids."""
    orig, refs = _planes(kind)
    r = 8
    refps = [np.pad(p, PAD, mode="edge") for p in refs]
    with no_jax_cache_writes():
        exp = me_mxu.me_grids_multi2_async(
            jax.device_put(orig), [jax.device_put(p) for p in refps], 32, 16,
            r, LAM_FP, pad=PAD)()
    got = me_ssd.me_grids_multi2_async(
        torch.from_numpy(orig),
        [me_ssd.pad_ref_device(torch.from_numpy(p), PAD) for p in refs],
        32, 16, r, LAM_FP, pad=PAD)()
    assert len(got) == len(exp) == 3
    for g, e, refp in zip(got, exp, refps):
        assert len(g) == len(e) == 4
        for a, b in zip(g, e):
            np.testing.assert_array_equal(a, b)
        for k, size in ((0, 32), (2, 16)):
            gx, gy = me_mxu.me_grid_ssd_np(orig, refp, size, r, LAM_FP,
                                           pad=PAD)
            np.testing.assert_array_equal(g[k], gx)
            np.testing.assert_array_equal(g[k + 1], gy)


def test_pad_and_window_energies_match_jax():
    orig, refs = _planes("moving")
    refp_t = me_ssd.pad_ref_device(torch.from_numpy(refs[0]), PAD)
    np.testing.assert_array_equal(refp_t.numpy(),
                                  np.pad(refs[0], PAD, mode="edge"))
    size, r = 16, 8
    ny, nx = H // size, W // size
    roi = _roi(refp_t.numpy(), size, r, ny, nx)
    p2 = (roi.astype(np.int32) - 128) ** 2
    with no_jax_cache_writes():
        exp = np.asarray(jax.jit(functools.partial(
            me_mxu._window_energies, size=size, r=r, ny=ny, nx=nx))(p2))
    got = me_ssd._window_energies(torch.from_numpy(p2), size=size, r=r,
                                  ny=ny, nx=nx)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_local_only_is_read_at_first_use(monkeypatch):
    """HEVC_TPU_ME_LOCAL_ONLY as the reference sees it: read when a search
    shape is first used, then kept for that shape (me_mxu reads it while
    tracing the jitted program). The shape here (r = 5, 16-grid) is used
    by no other test."""
    orig, refs = _planes("moving")
    size, r = 16, 5
    ny, nx = H // size, W // size
    refp = np.pad(refs[0], PAD, mode="edge")
    roi = _roi(refp, size, r, ny, nx)
    lam_q8 = me_mxu.lam_q8_of(LAM_FP)
    bits0 = me_mxu.bits0_table(r)
    monkeypatch.setenv("HEVC_TPU_ME_LOCAL_ONLY", "1")
    with no_jax_cache_writes():
        jitted = jax.jit(functools.partial(me_mxu._argmin_two_pass, r=r,
                                           ny=ny, nx=nx))
        ssd = np.array(jax.jit(functools.partial(
            me_mxu._ssd_table, size=size, r=r, ny=ny, nx=nx))(roi, orig))
        first_j = np.asarray(jitted(ssd, bits0, np.int32(lam_q8)))
        first_t = me_ssd._argmin_two_pass(
            torch.from_numpy(ssd), torch.from_numpy(bits0), lam_q8, r=r,
            ny=ny, nx=nx, size=size).numpy()
        monkeypatch.delenv("HEVC_TPU_ME_LOCAL_ONLY")
        again_j = np.asarray(jitted(ssd, bits0, np.int32(lam_q8)))
        again_t = me_ssd._argmin_two_pass(
            torch.from_numpy(ssd), torch.from_numpy(bits0), lam_q8, r=r,
            ny=ny, nx=nx, size=size).numpy()
    np.testing.assert_array_equal(first_t, first_j)
    np.testing.assert_array_equal(again_t, again_j)
    np.testing.assert_array_equal(again_t, first_t)


def test_unported_options_raise():
    """Every option of the search is ported: a mesh search returns the
    unsharded grids (and no refine tables, as the reference computes none
    under a mesh); weighted prediction and the refine tables return grids,
    the refine tables as a fifth entry."""
    from hevc_tpu_torch import parallel
    rng = np.random.default_rng(2)
    orig = torch.from_numpy(rng.integers(0, 256, (96, 64)).astype(np.uint8))
    ref = me_ssd.pad_ref_device(orig.roll((2, -3), (0, 1)), PAD)
    exp = me_ssd.me_grids_multi2_async(orig, [ref], 32, 16, 8, LAM_FP,
                                       pad=PAD)()
    got = me_ssd.me_grids_multi2_async(
        orig, [ref], 32, 16, 8, LAM_FP, pad=PAD, refine=True,
        mesh=parallel.make_mesh(2, device="cpu"))()
    assert [len(g) for g in got] == [4]
    for a, b in zip(got[0], exp[0]):
        np.testing.assert_array_equal(a, b)
    for kw, n in (({"refine": True}, 5), ({"wp": [(64, 2, 6)]}, 4)):
        out = me_ssd.me_grids_multi2_async(orig, [ref], 32, 16, 8, LAM_FP,
                                           pad=PAD, **kw)()
        assert [len(g) for g in out] == [n]
