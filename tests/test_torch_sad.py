"""hevc_tpu_torch.ops.sad (the SAD-table kernel's plain version, the
cost + argmin and the full search's CPU route) against hevc_tpu's Pallas
sad_table in interpret mode, its full searches and the numpy full search.
All comparisons are exact.

hevc_tpu's full_search_batch_pallas is jitted around a Pallas call that
runs only in interpret mode on the CPU, so its body runs through
`.__wrapped__` with `sad_table` patched in the test (to its interpret-mode
form, or to return a given table); nothing in hevc_tpu changes."""
import functools
import unittest.mock as um

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.ops import me as jme
from hevc_tpu.ops import sad_pallas
from hevc_tpu.ops.sad_pallas import sad_table as jax_sad_table
from hevc_tpu_torch.ops import me, sad
from test_torch_helpers import (SAD_KINDS, SAD_SHAPES, SEARCH_KINDS,
                                SEARCH_LAMS, cost_table, no_jax_cache_writes,
                                sad_range_case, search_case)
from test_torch_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n,h,w,R,seed", [
    (2, 8, 8, 2, 3),      # tests/test_inter_ops.py test_pallas_sad_table
    (5, 16, 16, 4, 9),    # tests/test_inter_ops.py full-search shapes
    (3, 8, 16, 3, 4),     # non-square block
])
def test_sad_table_matches_pallas_interpret(n, h, w, R, seed):
    rng = np.random.default_rng(seed)
    blks = rng.integers(0, 256, (n, h, w)).astype(np.int32)
    areas = rng.integers(0, 256, (n, h + 2 * R, w + 2 * R)).astype(np.int32)
    with no_jax_cache_writes():
        exp = np.asarray(jax_sad_table(blks, areas, h=h, w=w, ny=2 * R + 1,
                                       nx=2 * R + 1, interpret=True))
    got = sad.sad_table(torch.from_numpy(blks), torch.from_numpy(areas))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("h,w,ny,nx", SAD_SHAPES)
@pytest.mark.parametrize("kind", SAD_KINDS)
def test_sad_table_ranges_match_pallas_interpret(kind, h, w, ny, nx):
    """The plain version, which the card tests hold the kernel to, against
    the Pallas kernel at every sample range the kernel branches on (8-bit,
    10-16 bits, negative values whose sums wrap in int32, one launch mixing
    them all), on non-square blocks and searches and 64 x 64 blocks at
    R = 1 .. 4, with an odd N."""
    n = 7
    blks, areas = sad_range_case(kind, n, h, w, ny, nx, seed=h * ny + nx)
    with no_jax_cache_writes():
        exp = np.asarray(jax_sad_table(blks, areas, h=h, w=w, ny=ny, nx=nx,
                                       interpret=True))
    got = sad.sad_table(torch.from_numpy(blks), torch.from_numpy(areas))
    assert got.dtype == torch.int32 and got.shape == (n, ny, nx)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_sad_table_fallback_shape_mixed_ranges():
    """The fallback path's 1080p block shape (32 x 32, 129 x 129 offsets)
    with one block of every sample range, against the Pallas kernel."""
    blks, areas = sad_range_case("mixed", 7, 32, 32, 129, 129, seed=1)
    with no_jax_cache_writes():
        exp = np.asarray(jax_sad_table(blks, areas, h=32, w=32, ny=129,
                                       nx=129, interpret=True))
    got = sad.sad_table(torch.from_numpy(blks), torch.from_numpy(areas))
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("seed,flat", [(9, False), (11, False), (2, True)])
def test_full_search_batch_matches_numpy(seed, flat):
    """Plain full search and the kernel route's CPU path against
    me.full_search_batch_np; the flat case is all ties (first minimum)."""
    rng = np.random.default_rng(seed)
    n, h, w, R = 5, 16, 16, 4
    if flat:
        blks = np.full((n, h, w), 100, np.int32)
        areas = np.full((n, h + 2 * R, w + 2 * R), 100, np.int32)
    else:
        blks = rng.integers(0, 256, size=(n, h, w)).astype(np.int32)
        areas = rng.integers(0, 256, size=(n, h + 2 * R, w + 2 * R)
                             ).astype(np.int32)
    mins = np.full(n, -R, np.int32)
    py = rng.integers(-8, 8, n).astype(np.int32)
    px = rng.integers(-8, 8, n).astype(np.int32)
    exp = jme.full_search_batch_np(blks, areas, mins, mins, py, px, 40000)
    t = torch.from_numpy
    args = (t(blks), t(areas), t(mins), t(mins), t(py), t(px), 40000)
    for got in (me.full_search_batch(*args),
                sad.full_search_batch_kernel(*args)):
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), e)


def test_mv_bits_exact():
    """The five-step bit length equals the exp-Golomb length everywhere
    the search reaches and at the int32 extremes of its argument."""
    v = np.concatenate([np.arange(-5000, 5000),
                        [-(1 << 29), (1 << 29) - 1, 1 << 29]])
    got = me.mv_bits(torch.from_numpy(v.astype(np.int32))).numpy()
    exp = np.array([jme.mv_bits_np(int(x)) for x in v])
    np.testing.assert_array_equal(got, exp)


def _jax_pallas_search(args, lam_fp, table=None):
    """full_search_batch_pallas's body on the CPU: the Pallas sad_table in
    interpret mode (or, given `table`, that table) and its XLA cost +
    argmin epilogue."""
    blks, areas = args[:2]
    n, h, w = blks.shape
    kw = dict(h=h, w=w, ny=areas.shape[1] - h + 1, nx=areas.shape[2] - w + 1)
    tab = (functools.partial(jax_sad_table, interpret=True) if table is None
           else lambda *a, **k: jnp.asarray(table))
    with no_jax_cache_writes(), um.patch.object(sad_pallas, "sad_table",
                                                tab):
        out = jme.full_search_batch_pallas.__wrapped__(
            *map(jnp.asarray, args), jnp.asarray(np.int32(lam_fp)), **kw)
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("h,w,ny,nx", [(16, 16, 5, 5), (8, 16, 3, 7)])
@pytest.mark.parametrize("kind", SEARCH_KINDS)
def test_full_search_kernel_route_matches_jax(kind, h, w, ny, nx):
    """full_search_batch_kernel's CPU route (the plain version the card
    tests hold the fused kernel to) against hevc_tpu's XLA full search and
    full_search_batch_pallas (Pallas table in interpret mode): every
    sample range (negative samples whose sums wrap among them), all-ties
    tables, two zero bucket-padding rows, per-block mv_min and predictors
    that are not zero, and a lam_fp whose products with the rate bits wrap
    in int32."""
    args = search_case(kind, 5, h, w, ny, nx, seed=h + 3 * nx, padding=2)
    t = [torch.from_numpy(a) for a in args]
    for lam_fp in SEARCH_LAMS:
        with no_jax_cache_writes():
            xla = [np.asarray(o) for o in jme.full_search_batch(
                *args, np.int32(lam_fp), h=h, w=w, ny=ny, nx=nx)]
        pallas = _jax_pallas_search(args, lam_fp)
        got = sad.full_search_batch_kernel(*t, lam_fp)
        assert len(got) == 4
        for g, a, b in zip(got, xla, pallas):
            assert g.dtype == torch.int32 and g.shape == (7,)
            np.testing.assert_array_equal(g.numpy(), a)
            np.testing.assert_array_equal(g.numpy(), b)


@pytest.mark.parametrize("n,ny,nx", [(1, 1, 1), (7, 5, 5), (7, 3, 7),
                                     (5, 2, 3), (3, 1, 9), (2, 33, 31)])
@pytest.mark.parametrize("table", ["random", "flat", "huge"])
def test_cost_argmin_plain_matches_jax_epilogue(table, n, ny, nx):
    """cost_argmin's plain version (the card tests' oracle for
    sad_cost_argmin) against full_search_batch_pallas's epilogue applied
    to the same table: ties everywhere ("flat"), SADs near INT32_MAX whose
    cost wraps ("huge"), single offsets and rows, odd ny * nx."""
    sads = cost_table(table, n, ny, nx, seed=n * ny + nx)
    _, _, *vecs = search_case("8bit", n, 4, 4, ny, nx, seed=ny + nx)
    blks = np.zeros((n, 4, 4), np.int32)
    areas = np.zeros((n, ny + 3, nx + 3), np.int32)
    for lam_fp in SEARCH_LAMS:
        exp = _jax_pallas_search((blks, areas, *vecs), lam_fp, table=sads)
        got = sad.cost_argmin(torch.from_numpy(sads),
                              *map(torch.from_numpy, vecs), lam_fp)
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g.numpy(), e)
