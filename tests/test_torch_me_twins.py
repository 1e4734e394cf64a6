"""The test-only device twins of hevc_tpu_torch (ops/me_gpu_mode.py,
ops/me_exact.py and the device halves of ops/transform.py and ops/quant.py)
against hevc_tpu's XLA programs, exactly, on the CPU: the reference-GPU-mode
partition table and (mv, sad) tables, the HM-exact full search (ties on
flat content included), the core transforms at 8, 10 and 16 bits and the
quantizers. No encoder path calls them; tests/test_me_*.py and
tests/test_transform_quant.py call the reference's."""
import numpy as np
import pytest
import torch

from hevc_tpu.ops import me_exact as jax_me_exact
from hevc_tpu.ops import me_gpu_mode as jax_gpu_mode
from hevc_tpu.ops import quant as jax_quant
from hevc_tpu.ops import transform as jax_transform
from hevc_tpu_torch.ops import me_exact, me_gpu_mode, quant, transform
from test_torch_helpers import no_jax_cache_writes
from test_torch_helpers import one_torch_thread  # noqa: F401


def test_partition_tables_equal_reference():
    for amp in (True, False):
        assert me_gpu_mode.ctu_partitions(amp) == \
            jax_gpu_mode.ctu_partitions(amp)
        np.testing.assert_array_equal(me_gpu_mode.reduction_matrix(amp),
                                      jax_gpu_mode.reduction_matrix(amp))
        for i, p in enumerate(me_gpu_mode.ctu_partitions(amp)):
            assert me_gpu_mode.part_index(*p, amp) == i
    assert me_gpu_mode.window_lt((5, -9), 8, 0, 0, 192, 128) == \
        jax_gpu_mode.window_lt((5, -9), 8, 0, 0, 192, 128)


def _gm_planes(seed, w=192, h=128, pad=80):
    """tests/test_me_gpu_mode.py's content: random samples with a shifted
    copy planted, so the argmins are not degenerate."""
    rng = np.random.default_rng(seed)
    orig = rng.integers(0, 256, (h, w), np.int64)
    ref = rng.integers(0, 256, (h, w), np.int64)
    ref[8:72, 72:136] = orig[4:68, 68:132]
    return orig, np.pad(ref, pad, mode="edge")


@pytest.mark.parametrize("amp", [True, False])
@pytest.mark.parametrize("ctu_x,ctu_y,mvp,sr,lam", [
    (0, 0, (0, 0), 5, 400000), (128, 64, (-9, 14), 5, 400000),
    (64, 64, (6, -3), 6, 123456), (128, 64, (400, 300), 4, 0)])
def test_gpu_mode_tables_equal_reference(ctu_x, ctu_y, mvp, sr, lam, amp):
    """(mvx, mvy, sad) over every partition: the port's device twin on the
    CPU, hevc_tpu's XLA twin and the scalar model agree (a predictor far
    outside the picture clips the window at its edge)."""
    orig, refp = _gm_planes(2)
    ctu = orig[ctu_y:ctu_y + 64, ctu_x:ctu_x + 64]
    args = (ctu, refp, ctu_x, ctu_y, orig.shape[1], orig.shape[0], mvp, sr,
            lam, amp)
    with no_jax_cache_writes():
        ref = jax_gpu_mode.gpu_mode_tables(*args)
    got = me_gpu_mode.gpu_mode_tables(*args, device="cpu")
    model = me_gpu_mode.gpu_mode_tables_np(*args)
    for g, r, m in zip(got, ref, model):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, m)
        assert g.dtype == r.dtype


def test_cell_sads_equal_reference():
    rng = np.random.default_rng(4)
    ctu = rng.integers(0, 1 << 16, (64, 64)).astype(np.int32)
    area = rng.integers(0, 1 << 16, (64 + 2 * 3, 64 + 2 * 3)).astype(
        np.int32)
    with no_jax_cache_writes():
        import jax.numpy as jnp
        ref = np.asarray(jax_gpu_mode._cell_sads_dev(jnp.asarray(ctu),
                                                     jnp.asarray(area), 3))
    got = me_gpu_mode._cell_sads_dev(torch.from_numpy(ctu),
                                     torch.from_numpy(area), 3)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_hm_full_search_equals_reference():
    """tests/test_me_exact.py's trials (random content, predictors,
    lambdas, block sizes 8..64, flat pictures where only the first-minimum
    rule breaks ties), plus 16-bit samples."""
    rng = np.random.default_rng(11)
    pic_w, pic_h = 192, 128
    for trial in range(14):
        top = 1 << 16 if trial >= 12 else 256
        if trial % 3 == 0:
            plane = np.full((pic_h, pic_w), top // 2, np.int32)
            cur = plane.copy()
        else:
            plane = rng.integers(0, top, (pic_h, pic_w)).astype(np.int32)
            dx, dy = rng.integers(-5, 6, 2)
            cur = np.roll(np.roll(plane, dy, 0), dx, 1)
        ref = np.pad(plane, 96, mode="edge")
        n = int(rng.choice([8, 16, 32, 64]))
        cx = int(rng.integers(0, (pic_w - n) // 8 + 1)) * 8
        cy = int(rng.integers(0, (pic_h - n) // 8 + 1)) * 8
        mvp = (int(rng.integers(-16, 17)), int(rng.integers(-16, 17)))
        lam = int(rng.integers(1, 300)) * 256
        sr = int(rng.choice([8, 16]))
        blk = cur[cy:cy + n, cx:cx + n]
        args = (blk, ref, cx, cy, mvp, lam, sr, pic_w, pic_h)
        with no_jax_cache_writes():
            want = jax_me_exact.hm_full_search(*args)
        assert me_exact.hm_full_search(*args, device="cpu") == want, trial
        assert me_exact.hm_full_search_np(*args) == want, trial
    assert me_exact.search_window((3, -7), 16, 64, 0, 192, 128) == \
        jax_me_exact.search_window((3, -7), 16, 64, 0, 192, 128)


@pytest.mark.parametrize("bit_depth", [8, 10, 16])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_transforms_equal_reference(size, bit_depth):
    rng = np.random.default_rng(size + bit_depth)
    lim = (1 << bit_depth) - 1
    r = rng.integers(-lim, lim + 1, (5, size, size)).astype(np.int32)
    c = rng.integers(-32768, 32768, (5, size, size)).astype(np.int32)
    with no_jax_cache_writes():
        fwd = np.asarray(jax_transform.forward_transform(
            r, size=size, bit_depth=bit_depth))
        inv = np.asarray(jax_transform.inverse_transform(
            c, size=size, bit_depth=bit_depth))
    got = transform.forward_transform(r, size=size, bit_depth=bit_depth,
                                      device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), fwd)
    np.testing.assert_array_equal(transform.inverse_transform(
        c, size=size, bit_depth=bit_depth, device="cpu").numpy(), inv)
    if size == 4:   # the 4x4 DST of intra luma
        with no_jax_cache_writes():
            fwd = np.asarray(jax_transform.forward_transform(
                r, size=4, bit_depth=bit_depth, is_dst=True))
            inv = np.asarray(jax_transform.inverse_transform(
                fwd, size=4, bit_depth=bit_depth, is_dst=True))
        got = transform.forward_transform(r, size=4, bit_depth=bit_depth,
                                          is_dst=True, device="cpu")
        np.testing.assert_array_equal(got.numpy(), fwd)
        np.testing.assert_array_equal(transform.inverse_transform(
            got, size=4, bit_depth=bit_depth, is_dst=True,
            device="cpu").numpy(), inv)


@pytest.mark.parametrize("bit_depth", [8, 10, 16])
@pytest.mark.parametrize("size", [4, 32])
def test_quant_equal_reference(size, bit_depth):
    rng = np.random.default_rng(size * bit_depth)
    c = rng.integers(-32768, 32768, (4, size, size)).astype(np.int32)
    for qp in (0, 17, 22, 37, 51):
        for intra in (True, False):
            with no_jax_cache_writes():
                ref = np.asarray(jax_quant.quantize(
                    c, size=size, qp=qp, bit_depth=bit_depth,
                    is_intra=intra))
            got = quant.quantize(c, size=size, qp=qp, bit_depth=bit_depth,
                                 is_intra=intra, device="cpu")
            np.testing.assert_array_equal(got.numpy(), ref)
        with no_jax_cache_writes():
            ref = np.asarray(jax_quant.dequantize(c, size=size, qp=qp,
                                                  bit_depth=bit_depth))
        np.testing.assert_array_equal(quant.dequantize(
            c, size=size, qp=qp, bit_depth=bit_depth, device="cpu").numpy(),
            ref)


def test_twins_refuse_a_missing_card():
    """Each twin runs on the card unless asked for the CPU: with no card,
    the default raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        transform.forward_transform(np.zeros((4, 4), np.int32), size=4)
    with pytest.raises(RuntimeError):
        quant.quantize(np.zeros((4, 4), np.int32), size=4, qp=22)
