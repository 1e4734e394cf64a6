"""hevc_tpu_torch.ops.sad (the SAD-table kernel's plain version and the
fused cost + argmin) against hevc_tpu's Pallas sad_table in interpret mode
and against the numpy full search. All comparisons are exact."""
import numpy as np
import pytest
import torch

from hevc_tpu.ops import me as jme
from hevc_tpu.ops.sad_pallas import sad_table as jax_sad_table
from hevc_tpu_torch.ops import me, sad
from test_torch_helpers import (SAD_KINDS, SAD_SHAPES, no_jax_cache_writes,
                                sad_range_case)


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
