"""hevc_tpu_torch.ops.sad's planes-in full search (sad_table_from_planes,
me_from_planes) against hevc_tpu.ops.sad_pallas's on JAX-CPU, exactly.

The JAX functions are jitted around a Pallas call that runs only in
interpret mode on the CPU, so their own bodies run through `.__wrapped__`
with `sad_table` (and, for me_from_planes, `sad_table_from_planes`)
patched in the test to their interpret-mode forms; nothing in hevc_tpu
changes."""
import functools
import unittest.mock as um

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.ops import sad_pallas
from hevc_tpu_torch.ops import me_ssd, sad
from test_torch_helpers import no_jax_cache_writes, planes_case
from test_torch_helpers import one_torch_thread  # noqa: F401

# (size, r, ny, nx, pad, kind): n = ny*nx < 128 everywhere (bucket padding)
CASES = [
    (8, 2, 3, 4, 4, "random"),
    (8, 4, 2, 5, 6, "random"),
    (16, 2, 2, 3, 2, "random"),
    (16, 4, 3, 2, 8, "moving"),
    (8, 4, 4, 3, 4, "flat"),      # every offset ties
]


def _planes(size, r, ny, nx, pad, kind, seed, dtype=np.uint8):
    """orig [H, W] and ref_padded [H+2pad, W+2pad]; H, W a little larger
    than the block grid so the unused margin is exercised too."""
    h, w = ny * size + 3, nx * size + 5
    rng = np.random.default_rng(seed)
    if kind == "flat":
        return (np.full((h + 2 * pad, w + 2 * pad), 77, dtype),
                np.full((h, w), 77, dtype))
    if kind == "moving":
        base = rng.integers(0, 256, (h + 2 * pad + 4, w + 2 * pad + 4))
        ref = base[:h + 2 * pad, :w + 2 * pad]
        orig = base[pad + 2:pad + 2 + h, pad + 3:pad + 3 + w]
        return ref.astype(dtype), orig.astype(dtype)
    return (rng.integers(0, 256, (h + 2 * pad, w + 2 * pad)).astype(dtype),
            rng.integers(0, 256, (h, w)).astype(dtype))


def _jax_patch():
    return um.patch.object(sad_pallas, "sad_table",
                           functools.partial(sad_pallas.sad_table,
                                             interpret=True))


def _jax_table(ref, orig, **kw):
    with no_jax_cache_writes(), _jax_patch():
        return np.asarray(sad_pallas.sad_table_from_planes.__wrapped__(
            jnp.asarray(ref), jnp.asarray(orig), **kw))


def _jax_me(ref, orig, bits, lam_fp, **kw):
    with no_jax_cache_writes(), _jax_patch(), um.patch.object(
            sad_pallas, "sad_table_from_planes",
            sad_pallas.sad_table_from_planes.__wrapped__):
        return np.asarray(sad_pallas.me_from_planes.__wrapped__(
            jnp.asarray(ref), jnp.asarray(orig), jnp.asarray(bits),
            jnp.asarray(np.int32(lam_fp)), **kw))


@pytest.mark.parametrize("size,r,ny,nx,pad,kind", CASES)
def test_sad_table_from_planes_matches_jax(size, r, ny, nx, pad, kind):
    ref, orig = _planes(size, r, ny, nx, pad, kind, seed=size * 7 + r)
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=pad)
    exp = _jax_table(ref, orig, **kw)
    got = sad.sad_table_from_planes(torch.from_numpy(ref),
                                    torch.from_numpy(orig), **kw)
    assert got.dtype == torch.int32
    assert got.shape == (128, 2 * r + 1, 2 * r + 1) == exp.shape
    np.testing.assert_array_equal(got.numpy(), exp)
    assert not got[ny * nx:].any()     # padded rows: zero against zero


@pytest.mark.parametrize("lam_fp,bits_kind", [
    (0, "zero"), (90000, "mv"), (123457, "random"), (-(1 << 30), "random")])
@pytest.mark.parametrize("size,r,ny,nx,pad,kind", CASES)
def test_me_from_planes_matches_jax(size, r, ny, nx, pad, kind, lam_fp,
                                    bits_kind):
    """Non-zero bits/lam_fp move the minimum; a large negative lam_fp
    wraps the int32 product. Padded rows take the argmin of the rate."""
    ref, orig = _planes(size, r, ny, nx, pad, kind, seed=size + 3 * r)
    nyx = 2 * r + 1
    if bits_kind == "zero":
        bits = np.zeros((nyx, nyx), np.int32)
    elif bits_kind == "mv":
        bits = me_ssd.bits0_table(r)
    else:
        bits = np.random.default_rng(r).integers(
            0, 1 << 20, (nyx, nyx)).astype(np.int32)
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=pad)
    exp = _jax_me(ref, orig, bits, lam_fp, **kw)
    got = sad.me_from_planes(torch.from_numpy(ref), torch.from_numpy(orig),
                             torch.from_numpy(bits), lam_fp, **kw)
    assert got.dtype == torch.int32 and got.shape == (128,) == exp.shape
    np.testing.assert_array_equal(got.numpy(), exp)


def test_planes_sample_types_and_strided_views():
    """int16 planes (the 9..14-bit transport dtype) and row-strided views
    give the uint8 result, and the JAX result."""
    size, r, ny, nx, pad = 8, 3, 2, 3, 5
    ref, orig = _planes(size, r, ny, nx, pad, "random", seed=5)
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=pad)
    exp = _jax_table(ref.astype(np.int16), orig.astype(np.int16), **kw)
    wide = torch.zeros((ref.shape[0], ref.shape[1] + 7), dtype=torch.int16)
    wide[:, :ref.shape[1]] = torch.from_numpy(ref.astype(np.int16))
    view = wide[:, :ref.shape[1]]
    assert not view.is_contiguous()
    got = sad.sad_table_from_planes(view, torch.from_numpy(
        orig.astype(np.int16)), **kw)
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(
        got.numpy(), sad.sad_table_from_planes(
            torch.from_numpy(ref), torch.from_numpy(orig), **kw).numpy())


@pytest.mark.parametrize("case", ["u8_view", "i16_10bit", "i16_15bit"])
@pytest.mark.parametrize("size,r,ny,nx,pad", [(8, 2, 3, 4, 4),
                                              (16, 4, 2, 5, 6)])
def test_planes_views_and_deep_samples_match_jax(size, r, ny, nx, pad,
                                                 case):
    """The plain versions, which the card test of the same cases holds the
    kernels to, against the JAX functions: uint8 views at odd columns with
    odd row strides, int16 planes of 10 and 15 bits. (The card test's
    32 x 32 cases take minutes in interpret mode and run there only.)"""
    ref, orig = ((big[y:y + hh, x:x + ww], torch.from_numpy(big)[
        y:y + hh, x:x + ww]) for big, (y, x, hh, ww) in planes_case(
            case, size, r, ny, nx, pad, seed=size + r + nx))
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=pad)
    got = sad.sad_table_from_planes(ref[1], orig[1], **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_table(ref[0], orig[0], **kw))
    nyx = 2 * r + 1
    bits = np.random.default_rng(size * r).integers(
        0, 40, (nyx, nyx)).astype(np.int32)
    for lam_fp in (0, 90000, -(1 << 30)):
        got = sad.me_from_planes(ref[1], orig[1], torch.from_numpy(bits),
                                 lam_fp, **kw)
        np.testing.assert_array_equal(
            got.numpy(), _jax_me(ref[0], orig[0], bits, lam_fp, **kw))


def test_planes_reject_windows_outside_the_plane():
    size, r, ny, nx, pad = 8, 4, 2, 2, 4
    ref, orig = _planes(size, r, ny, nx, pad, "random", seed=1)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="pad"):
        sad.sad_table_from_planes(t(ref), t(orig), size=size, r=r, ny=ny,
                                  nx=nx, pad=r - 1)
    with pytest.raises(ValueError, match="too small"):
        sad.sad_table_from_planes(t(ref[:-12]), t(orig), size=size, r=r,
                                  ny=ny, nx=nx, pad=pad)
    with pytest.raises(ValueError, match="bits"):
        sad.me_from_planes(t(ref), t(orig),
                           torch.zeros((3, 3), dtype=torch.int32), 0,
                           size=size, r=r, ny=ny, nx=nx, pad=pad)
