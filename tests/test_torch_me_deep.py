"""The deep-bit-depth search of hevc_tpu_torch.ops.me_ssd against
hevc_tpu.ops.me_mxu on JAX-CPU: the deep SSD table (the port's plain
version against the reference's three int8 correlations of the hi/lo
split), the deep window-energy box plane, and the two-grid
multi-reference MV grids at 10 and 12 bits (also against the numpy twin
me_grid_ssd_np). Exact integer equality throughout; the flat frames make
every SSD equal, so the argmins are decided by ties (first minimum)."""
import functools

import jax
import numpy as np
import pytest
import torch

from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.ops import me_ssd
from test_torch_helpers import at_depth, moving_frames, no_jax_cache_writes
from test_torch_helpers import one_torch_thread  # noqa: F401

PAD = 80
W, H = 128, 96
LAM_FP = 120000


def _planes(kind, depth):
    """orig and three references at `depth` bits: moving texture, all flat
    (every SSD ties), or a flat source against textured references."""
    if kind == "moving":
        f = moving_frames(4, W, H, seed=7 + depth)
        return (at_depth(f[3][0], depth),
                [at_depth(f[k][0], depth) for k in (2, 1, 0)])
    if kind == "flat":
        flat = np.full((H, W), 1 << (depth - 1), np.int16)
        return flat, [flat] * 3
    f = moving_frames(3, W, H, seed=3)
    return (np.full((H, W), 90 << (depth - 8), np.int16),
            [at_depth(f[k][0], depth) for k in range(3)])


def _roi(refp, size, r, ny, nx):
    aw = 2 * r + size
    return refp[PAD - r:PAD - r + (ny - 1) * size + aw,
                PAD - r:PAD - r + (nx - 1) * size + aw]


@pytest.mark.parametrize("kind", ["moving", "flat", "flat_src"])
@pytest.mark.parametrize("size,r", [(8, 3), (16, 8), (32, 8)])
@pytest.mark.parametrize("depth", [10, 12])
def test_ssd_table_deep_matches_jax(depth, size, r, kind):
    orig, refs = _planes(kind, depth)
    refp = np.pad(refs[0], PAD, mode="edge")
    ny, nx = H // size, W // size
    roi = _roi(refp, size, r, ny, nx)
    with no_jax_cache_writes():
        exp = np.asarray(jax.jit(functools.partial(
            me_mxu._ssd_table_deep, size=size, r=r, ny=ny, nx=nx,
            depth=depth))(roi, orig))
    got = me_ssd._ssd_table_deep(torch.from_numpy(roi),
                                 torch.from_numpy(orig), size=size, r=r,
                                 ny=ny, nx=nx, depth=depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("size", [8, 16, 32])
@pytest.mark.parametrize("depth", [10, 12, 14])
def test_deep_box_energies_match_jax(depth, size):
    """The whole box plane of the centred deep squares: with one block and
    2r + 1 = the plane's side - size + 1 offsets, the reference's
    _window_energies returns its box plane unpermuted."""
    f = moving_frames(1, 80, 80, seed=depth + size)
    plane = at_depth(f[0][0], depth)[:2 * 24 + size, :2 * 24 + size]
    shift, mid = me_ssd.deep_centring(depth)
    rc = (plane.astype(np.int32) >> shift) - mid
    with no_jax_cache_writes():
        exp = np.asarray(jax.jit(functools.partial(
            me_mxu._window_energies, size=size, r=24, ny=1, nx=1))(
                rc * rc))[0]
    got = me_ssd.box_energies(torch.from_numpy(plane), size, shift, mid)
    assert got.shape == exp.shape == (49, 49)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("kind", ["moving", "flat", "flat_src"])
@pytest.mark.parametrize("depth", [10, 12])
def test_me_grids_multi2_deep_matches_jax_and_numpy(depth, kind):
    """Three references (the JAX side pads them to four), both grids, on
    int16 planes: the deep table and the rate term scaled by _lam_shift."""
    orig, refs = _planes(kind, depth)
    r = 8
    refps = [np.pad(p, PAD, mode="edge") for p in refs]
    with no_jax_cache_writes():
        exp = me_mxu.me_grids_multi2_async(
            jax.device_put(orig), [jax.device_put(p) for p in refps], 32, 16,
            r, LAM_FP, pad=PAD, depth=depth)()
    got = me_ssd.me_grids_multi2_async(
        torch.from_numpy(orig),
        [me_ssd.pad_ref_device(torch.from_numpy(p), PAD) for p in refs],
        32, 16, r, LAM_FP, pad=PAD, depth=depth)()
    assert len(got) == len(exp) == 3
    for g, e, refp in zip(got, exp, refps):
        for a, b in zip(g, e):
            np.testing.assert_array_equal(a, b)
        for k, size in ((0, 32), (2, 16)):
            gx, gy = me_mxu.me_grid_ssd_np(orig, refp, size, r, LAM_FP,
                                           pad=PAD, depth=depth)
            np.testing.assert_array_equal(g[k], gx)
            np.testing.assert_array_equal(g[k + 1], gy)


@pytest.mark.parametrize("depth", [8, 9, 10, 12, 14])
def test_deep_centring_and_lam_shift_match_reference(depth):
    assert me_ssd._lam_shift(depth) == me_mxu._lam_shift(depth)
    if depth > 8:
        shift, mid = me_ssd.deep_centring(depth)
        assert (shift, mid) == (max(0, depth - 10),
                                1 << (min(depth, 10) - 1))


@pytest.mark.parametrize("depth,given", [(10, True), (10, False),
                                         (12, True)])
@pytest.mark.parametrize("size", [16, 32])
def test_batched_me_grid_deep_matches_reference(size, depth, given):
    """The encoder's one-reference search entry at deep bit depths (the path
    with the multi-reference launch turned off), the depth given or found
    from the samples, against hevc_tpu's (its numpy twin on JAX-CPU)."""
    from hevc_tpu.encoder import native_frame as jax_native_frame
    from hevc_tpu_torch.encoder import native_frame
    orig, refs = _planes("moving", depth)
    refp = np.pad(refs[0], PAD, mode="edge")
    kw = dict(depth=depth if given else None)
    exp = jax_native_frame.batched_me_grid(orig, refp, size, 8, LAM_FP, **kw)
    got = native_frame.batched_me_grid(orig, refp, size, 8, LAM_FP,
                                       device="cpu", **kw)
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a, b)
