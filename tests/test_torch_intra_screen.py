"""hevc_tpu_torch.ops.intra_screen (35-mode SATD prescreen as torch ops)
against hevc_tpu.ops.intra_screen on JAX-CPU. Flat blocks make many
modes cost the same, so the top-k order of equal costs (lowest mode
first, as lax.top_k) is checked too. Exact equality."""
import numpy as np
import pytest
import torch

from hevc_tpu.ops import intra as jintra
from hevc_tpu.ops import intra_screen as jscreen
from hevc_tpu.ops import satd as jsatd
from hevc_tpu_torch.ops import intra, intra_screen, satd
from test_torch_helpers import moving_frames, no_jax_cache_writes
from test_torch_helpers import one_torch_thread  # noqa: F401


def _frame(seed):
    y = moving_frames(1, 64, 64, seed=seed)[0][0].astype(np.int16)
    y[:32, :32] = 77                                  # flat: all ties
    y[32:48, 32:64] = np.arange(32)[None, :] * 4      # smooth ramp
    y[48:, :16] = 200                                 # flat, other level
    return y


@pytest.mark.parametrize("seed,sqrt_lam", [(2, 5.3), (8, 11.0)])
def test_screen_frame_matches_jax(seed, sqrt_lam):
    y = _frame(seed)
    with no_jax_cache_writes():
        exp = jscreen.screen_frame(y, 8, sqrt_lam)
    got = intra_screen.screen_frame(y, 8, sqrt_lam, device="cpu")
    assert sorted(got) == sorted(exp) == [2, 3, 4, 5]
    for log2 in exp:
        cands_e, costs_e = exp[log2]
        cands_g, costs_g = got[log2]
        assert cands_g.dtype == np.uint8 and costs_g.dtype == np.int64
        np.testing.assert_array_equal(cands_g, cands_e)
        np.testing.assert_array_equal(costs_g, costs_e)
    # inside the flat corner every mode predicts the block exactly, so
    # the costs are the mode-bit estimates alone (2 for planar, 3 for DC
    # and vertical, 6 else): equal costs keep the lowest mode first
    assert list(got[3][0][1, 1]) == [0, 1, 26, 2, 3, 4, 5, 6]


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_predict_all_modes_and_satd_match_jax(size):
    rng = np.random.default_rng(size)
    b = 6
    f = rng.integers(0, 256, (b, 4 * size + 1)).astype(np.int32)
    ff = np.concatenate([f[:, :1], (f[:, :-2] + 2 * f[:, 1:-1] + f[:, 2:]
                                    + 2) >> 2, f[:, -1:]], axis=1)
    blocks = rng.integers(0, 256, (b, 1, size, size)).astype(np.int32)
    with no_jax_cache_writes():
        pe = np.asarray(jintra.predict_all_modes(f, ff, size=size))
        se = np.asarray(jsatd.satd_batch(pe, blocks, size=size))
    pg = intra.predict_all_modes(torch.from_numpy(f), torch.from_numpy(ff),
                                 size=size)
    np.testing.assert_array_equal(pg.numpy(), pe)
    sg = satd.satd_batch(pg, torch.from_numpy(blocks), size=size)
    np.testing.assert_array_equal(sg.numpy(), se)


def _plane(kind, h, w, bit_depth, seed):
    """flat (every mode ties), ramp, random over the full range, or moving
    texture with a flat patch, at bit_depth."""
    rng = np.random.default_rng(seed)
    top = 1 << bit_depth
    if kind == "flat":
        return np.full((h, w), top // 3, np.int16)
    if kind == "ramp":
        return ((np.arange(w)[None, :] * 3 + np.arange(h)[:, None] * 5)
                * top // (3 * w + 5 * h)).astype(np.int16)
    if kind == "full":
        return rng.choice([0, top - 1], (h, w)).astype(np.int16) | \
            rng.integers(0, top, (h, w)).astype(np.int16) * (
                rng.random((h, w)) < 0.5)
    y = moving_frames(1, w, h, seed=seed)[0][0].astype(np.int16)
    y = y << (bit_depth - 8)
    y[:h // 2, :w // 3] = top // 5
    return y


@pytest.mark.parametrize("kind", ["flat", "ramp", "full", "texture"])
@pytest.mark.parametrize("bit_depth", [8, 10, 12, 14])
def test_screen_frame_async_deep_and_clamped(bit_depth, kind):
    """72x40: the 16x16 and 32x32 grids leave rows and columns uncovered,
    so the top and left references clamp to the last column and row. A
    zero sqrt(lambda) leaves the SATD ties unbroken by the mode costs."""
    y = _plane(kind, 40, 72, bit_depth, seed=bit_depth)
    for sqrt_lam in (0.0, 7.7):
        with no_jax_cache_writes():
            exp = jscreen.screen_frame(y, bit_depth, sqrt_lam)
        got = intra_screen.screen_frame_async(y, bit_depth, sqrt_lam,
                                              device="cpu")()
        assert sorted(got) == sorted(exp) == [2, 3, 4, 5]
        for log2 in exp:
            assert got[log2][0].shape == (40 >> log2, 72 >> log2,
                                          intra_screen.K_OF_LOG2[log2])
            for g, e in zip(got[log2], exp[log2]):
                np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("lam", ["zeros", "constant", "bits", "random"])
def test_packed_outputs_with_tying_mode_costs(lam):
    """The packed (cands, costs) of `intra_screen` against the reference's
    `_screen_chunk` per size, concatenated in log2 order, for mode-cost
    tables that tie many modes (zero, constant, the planar/DC/vertical
    estimate) or none."""
    h, w, bd = 48, 80, 10
    y = _plane("texture", h, w, bd, seed=3)
    y[8:40, 16:48] = 300                       # a flat patch: SATD ties
    p = np.full((h + 1, w + 1), 1 << (bd - 1), np.int16)
    p[1:, 1:] = y
    lam_tab = {"zeros": np.zeros(35), "constant": np.full(35, 9),
               "bits": [4, 6] + [12] * 24 + [6] + [12] * 8,
               "random": np.random.default_rng(1).integers(0, 60, 35)}[lam]
    lam_tab = np.asarray(lam_tab, np.int32)
    cands, costs = [], []
    with no_jax_cache_writes():
        for log2 in (2, 3, 4, 5):
            n, k = 1 << log2, jscreen.K_OF_LOG2[log2]
            fi, bi = jscreen._index_maps(n, h // n, w // n, w, h)
            out = jscreen._screen_chunk(p, fi, bi, lam_tab, size=n,
                                        bit_depth=bd, k=k)
            if k:
                cands.append(np.asarray(out[0]).reshape(-1))
                out = out[1]
            costs.append(np.asarray(out))
    got = intra_screen.intra_screen(torch.from_numpy(p),
                                    torch.from_numpy(lam_tab), bit_depth=bd)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.concatenate(cands))
    np.testing.assert_array_equal(got[1].numpy(), np.concatenate(costs))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        intra_screen.screen_frame(np.zeros((16, 16), np.int32), 17, 1.0,
                                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            intra_screen.screen_frame(np.zeros((16, 16), np.int16), 8, 1.0)


@pytest.mark.parametrize("h,w,kind,bit_depth", [
    (88, 136, "flat", 8), (88, 136, "full", 14), (88, 136, "texture", 10),
    (104, 168, "ramp", 12), (104, 168, "full", 8), (104, 168, "texture", 14),
    (1120, 1952, "texture", 8)])
def test_screen_frame_partial_thread_blocks(h, w, kind, bit_depth):
    """The frame sizes of the card tests whose block counts leave the last
    thread block of the kernel partly empty (168x104 at every block size;
    136x88 and 1952x1120 at some), held to the reference first, so that the
    card tests' plain version stands for hevc_tpu there."""
    y = _plane(kind, h, w, bit_depth, seed=h + bit_depth)
    with no_jax_cache_writes():
        exp = jscreen.screen_frame(y, bit_depth, 6.1)
    got = intra_screen.screen_frame_async(y, bit_depth, 6.1, device="cpu")()
    assert sorted(got) == sorted(exp) == [2, 3, 4, 5]
    for log2 in exp:
        for g, e in zip(got[log2], exp[log2]):
            np.testing.assert_array_equal(g, e)
