"""Weighted prediction in the integer motion search: hevc_tpu_torch's
ops/me_ssd.wp_apply and wp_apply_multi (plain versions, and the host twin
encoder/native_frame.wp_apply_np) against hevc_tpu's me_mxu.wp_apply, the
search on the weighted reference against hevc_tpu's, and fade encodes with
WeightedPredP=1 (8-bit low-delay P) and WeightedPredB=1 (RA-Main10)
byte-identical between the packages on the CPU, every picture's MD5 SEI
checked by the port's decoder."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.encoder.native_frame import wp_apply_np as jax_wp_apply_np
from hevc_tpu.encoder.top import EncoderTop as JaxEncoderTop
from hevc_tpu.io.cfg import EncoderConfig as JaxEncoderConfig
from hevc_tpu.io.cfg import parse_cfg_file as jax_parse_cfg_file
from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.decoder.top import DecoderTop
from hevc_tpu_torch.encoder.native_frame import PAD, batched_me_grid
from hevc_tpu_torch.encoder.native_frame import wp_apply_np
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.io.cfg import config_from_reference
from hevc_tpu_torch.ops import me_ssd
from test_torch_helpers import (CFG_DIR, no_jax_cache_writes,
                                one_torch_thread,  # noqa: F401
                                private_reference_native)  # noqa: F401

# (w, o, denom): a fade's weight, the identity at denom 6, small and
# negative weights, zero weight, denom 0, the extremes of the syntax
TRIPLES = [(45, 12, 6), (64, 0, 6), (3, -10, 1), (1, 5, 0), (-20, 7, 3),
           (0, 9, 2), (-128, -128, 7), (255, 127, 7), (7, -3, 0)]


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_wp_apply_equals_reference(depth):
    rng = np.random.default_rng(depth)
    plane = rng.integers(0, 1 << depth, (48, 72)).astype(
        me_ssd.me_dtype(depth))
    for wpv in TRIPLES:
        with no_jax_cache_writes():
            ref = np.asarray(me_mxu.wp_apply(
                jnp.asarray(plane), jnp.asarray(np.array(wpv, np.int32)),
                depth))
        got = me_ssd.wp_apply(torch.from_numpy(plane), wpv, depth)
        assert got.dtype == torch.from_numpy(plane).dtype
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(wpv))
        np.testing.assert_array_equal(
            me_ssd.wp_apply_plain(torch.from_numpy(plane), wpv, depth),
            ref)
        np.testing.assert_array_equal(wp_apply_np(plane, wpv, depth), ref)
        np.testing.assert_array_equal(jax_wp_apply_np(plane, wpv, depth),
                                      ref)


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_wp_apply_multi_equals_reference(depth):
    """wp_apply_multi (its plain version here) against the reference's map
    of me_mxu.wp_apply over stacked planes with per-plane triples
    (me_mxu.py lax.map(one_wp, ...)), the identity among them."""
    import jax
    rng = np.random.default_rng(depth + 1)
    dt = me_ssd.me_dtype(depth)
    planes = rng.integers(0, 1 << depth, (len(TRIPLES), 40, 56)).astype(dt)
    wpvs = np.array(TRIPLES, np.int32)
    with no_jax_cache_writes():
        ref = np.asarray(jax.lax.map(
            lambda a: me_mxu.wp_apply(a[0], a[1], depth),
            (jnp.asarray(planes), jnp.asarray(wpvs))))
    got = me_ssd.wp_apply_multi([torch.from_numpy(p) for p in planes],
                                TRIPLES, depth)
    assert len(got) == len(TRIPLES)
    for g, e in zip(got, ref):
        assert g.dtype == torch.from_numpy(planes[0]).dtype
        np.testing.assert_array_equal(g.numpy(), e)
    np.testing.assert_array_equal(
        me_ssd.wp_apply_multi_plain([torch.from_numpy(planes[1])],
                                    [TRIPLES[1]], depth)[0].numpy(), ref[1])


def test_wp_operand_equals_reference():
    for wp, nref, npad in (([None, (45, 12, 6)], 2, 2),
                           ([(3, -10, 1)], 3, 4), (None, 2, 2),
                           ([None, None, (1, 5, 0)], 3, 4)):
        np.testing.assert_array_equal(me_ssd.wp_operand(wp, nref, npad),
                                      me_mxu.wp_operand(wp, nref, npad))


def _fade_pair(depth, h=96, w=160, seed=5):
    """A reference and the next picture: the reference's content displaced
    by MV (-5, -3), faded by a 0.6 gain and a -50 offset (at 8 bits)."""
    rng = np.random.default_rng(seed)
    base = np.repeat(np.repeat(rng.integers(60, 180, (h // 4 + 8,
                                                      w // 4 + 8)), 4, 0),
                     4, 1).astype(np.float64)
    ref = base[8:8 + h, 8:8 + w]
    cur = np.clip(base[5:5 + h, 3:3 + w] * 0.6 - 50, 0, 255)
    k = 1 << (depth - 8)
    dt = me_ssd.me_dtype(depth)
    return ((cur * k).astype(dt),
            np.pad((ref * k).astype(dt), PAD, mode="edge"))


@pytest.mark.parametrize("depth", [8, 10])
def test_me_idx_frame_weighted_equals_reference(depth):
    """The search on the weighted reference: indices of both grid sizes
    equal hevc_tpu's me_idx_frame(wpv=...), and the weights recover the
    displacement the fade hides."""
    cur, refp = _fade_pair(depth)
    wpv = (38, -50, 6)
    h, w = cur.shape
    for size, r in ((32, 8), (16, 8)):
        kw = dict(size=size, r=r, ny=h // size, nx=w // size, pad=PAD,
                  depth=depth)
        with no_jax_cache_writes():
            ref = np.asarray(me_mxu.me_idx_frame(
                jnp.asarray(cur), jnp.asarray(refp), me_mxu._bits0_dev(r),
                jnp.int32(40), wpv=jnp.asarray(np.array(wpv, np.int32)),
                **kw))
        got = me_ssd.me_idx_frame(
            torch.from_numpy(cur), torch.from_numpy(refp),
            me_ssd._bits0_dev(r, torch.device("cpu")), 40, wpv=wpv, **kw)
        np.testing.assert_array_equal(got.numpy(), ref)
    gx, gy = batched_me_grid(cur, refp, 32, 8, 1000, depth=depth, wpv=wpv,
                             device="cpu")
    assert int(((gx == -5) & (gy == -3)).sum()) >= gx.size * 0.8


def test_me_grids_multi2_weighted_equals_reference():
    """Two references, one weighted and one not (the identity operand),
    with refine asked for: the grids equal hevc_tpu's, and no refine table
    comes back (weighted prediction turns the tables off)."""
    cur, refp = _fade_pair(8, h=128, w=192)
    ref2 = np.roll(refp, 2, axis=1)
    wp = [(38, -50, 6), None]
    with no_jax_cache_writes():
        ref = me_mxu.me_grids_multi2(
            jnp.asarray(cur), [jnp.asarray(refp), jnp.asarray(ref2)], 32, 16,
            12, 60000, pad=PAD, depth=8, wp=wp, refine=True)
    got = me_ssd.me_grids_multi2(
        torch.from_numpy(cur), [torch.from_numpy(refp),
                                torch.from_numpy(ref2)], 32, 16, 12, 60000,
        pad=PAD, depth=8, wp=wp, refine=True)
    assert [len(g) for g in got] == [len(g) for g in ref] == [4, 4]
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_me_grids_multi2_weighted_three_refs_equals_reference():
    """Three references with a triple each (one the identity), searched
    after one wp_apply_multi over all of them: the grids equal hevc_tpu's
    me_grids_multi2(wp=...)."""
    cur, refp = _fade_pair(8, h=128, w=192)
    refs = [refp, np.roll(refp, 2, axis=1), np.roll(refp, -3, axis=0)]
    wp = [(38, -50, 6), None, (45, 12, 6)]
    with no_jax_cache_writes():
        ref = me_mxu.me_grids_multi2(
            jnp.asarray(cur), [jnp.asarray(r) for r in refs], 32, 16, 12,
            60000, pad=PAD, depth=8, wp=wp)
    got = me_ssd.me_grids_multi2(
        torch.from_numpy(cur), [torch.from_numpy(r) for r in refs], 32, 16,
        12, 60000, pad=PAD, depth=8, wp=wp)
    assert [len(g) for g in got] == [len(g) for g in ref] == [4, 4, 4]
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _fade_frames(n, w, h, depth, seed=11):
    """n pictures [Y, Cb, Cr] of blocky texture panning by (3, 2) under a
    gain ramp (1 - 0.12 t), chroma flat; at `depth` bits (int16 above 8)."""
    rng = np.random.default_rng(seed)
    base = np.repeat(np.repeat(
        rng.integers(40, 215, (h // 4 + 4 * n, w // 4 + 4 * n)), 4, 0),
        4, 1).astype(np.float64)
    k = 1 << (depth - 8)
    dt = np.uint8 if depth == 8 else np.int16
    out = []
    for t in range(n):
        win = base[8 + 2 * t:8 + 2 * t + h, 8 + 3 * t:8 + 3 * t + w]
        y = np.clip(win * (1.0 - 0.12 * t), 0, 255) * k
        c = np.full((h // 2, w // 2), 128 * k)
        out.append([y.astype(dt), c.astype(dt), c.astype(dt)])
    return out


@pytest.mark.parametrize("name,w,h,n,depth", [
    ("encoder_lowdelay_P_main.cfg", 192, 128, 4, 8),
    ("encoder_randomaccess_main10.cfg", 96, 64, 9, 10)])
def test_fade_encode_stream_identical(monkeypatch, name, w, h, n, depth):
    """WeightedPredP=1 on the LDP cfg, WeightedPredB=1 (and P) on
    RA-Main10: the analysis finds weights, the port searches on weighted
    references (wp_apply with non-identity triples), and the streams are
    byte-identical; every picture's hash checks."""
    weighted = []
    real = me_ssd.wp_apply_multi

    def spy(planes, wpvs, depth):
        weighted.extend(tuple(int(v) for v in t) != (1, 0, 0) for t in wpvs)
        return real(planes, wpvs, depth)
    monkeypatch.setattr(me_ssd, "wp_apply_multi", spy)
    cfg = jax_parse_cfg_file(os.path.join(CFG_DIR, name), JaxEncoderConfig())
    cfg.width, cfg.height, cfg.frames_to_encode = w, h, n
    cfg.input_bit_depth = cfg.internal_bit_depth
    cfg.search_range = 12
    cfg.weighted_pred_p = 1
    cfg.weighted_pred_b = int(depth > 8)
    frames = _fade_frames(n, w, h, depth)
    with no_jax_cache_writes():
        enc = JaxEncoderTop(cfg)
        ref = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    enc = EncoderTop(config_from_reference(dataclasses.asdict(cfg)),
                     device="cpu")
    got = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    assert len(got) > 0 and got == ref
    assert any(weighted)
    dec = DecoderTop()
    assert sum(1 for _ in dec.decode_stream(got)) == n
    assert dec.hash_status == ["OK"] * n
