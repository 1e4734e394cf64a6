"""The fractional-refine tables (HEVC_TPU_ME_REFINE=1): hevc_tpu_torch's
ops/me_ssd.refine_tables against hevc_tpu's device program
(me_mxu._me_idx_multi2_jit(refine=True), which runs _build_phases,
_satd_of_tiles and _refine_direct), exactly, on the CPU: the tables at 8
and 10 bits, at SearchRange 78 where the tile starts are clamped into the
phase planes, an independent host replay of the engine's refinement
(interp.mc_predict_np + intra_frame.satd), and whole encodes with the
tables on."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.encoder.top import EncoderTop as JaxEncoderTop
from hevc_tpu.io.cfg import EncoderConfig as JaxEncoderConfig
from hevc_tpu.io.cfg import parse_cfg_file as jax_parse_cfg_file
from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.decoder.top import DecoderTop
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.io.cfg import config_from_reference
from hevc_tpu_torch.ops import me_ssd
from test_torch_helpers import (LDP_CFG, moving_frames, no_jax_cache_writes,
                                one_torch_thread,  # noqa: F401
                                private_reference_native)  # noqa: F401

PAD = 80
SIZE, SIZE2 = 32, 16


def _planes(depth, h=96, w=128, seed=9):
    """orig [h, w] and the padded reference, in me_dtype(depth): smooth
    random texture, the reference a blend of two copies of it displaced
    by (2, 3) and (3, 4) samples whose weight runs from 0 to 1 across the
    picture (so the refinement lands on many offsets), with noise, inside
    a border of random samples."""
    from scipy.ndimage import uniform_filter
    rng = np.random.default_rng(seed + depth)
    top = 1 << depth
    base = uniform_filter(rng.random((h + 8, w + 8)), 5)
    base = np.clip((base - base.mean()) * 6 + 0.5, 0, 1) * (top - 1)
    orig = np.rint(base[4:4 + h, 4:4 + w])
    ref = rng.integers(0, top, (h, w)).astype(np.float64)
    a = np.linspace(0, 1, 112)[None]
    ref[4:84, 6:118] = (a * base[2:82, 3:115] + (1 - a) * base[3:83, 4:116]
                        + rng.integers(-2, 3, (80, 112)) * (top >> 8))
    dt = me_ssd.me_dtype(depth)
    ref = np.clip(np.rint(ref), 0, top - 1)
    return orig.astype(dt), np.pad(ref, PAD, mode="edge").astype(dt)


def _jax_tables(orig, refp, r, depth):
    """hevc_tpu's packed (i1, i2, off1, half1, off2, half2) of one
    reference at lam_q8 = 1."""
    h, w = orig.shape
    r2 = min(r, 16)
    with no_jax_cache_writes():
        packed = np.asarray(me_mxu._me_idx_multi2_jit(
            jnp.asarray(orig), jnp.asarray(refp[None]),
            me_mxu._bits0_dev(r), me_mxu._bits0_dev(r2), jnp.int32(1),
            size=SIZE, size2=SIZE2, r=r, r2=r2, ny=h // SIZE, nx=w // SIZE,
            ny2=h // SIZE2, nx2=w // SIZE2, pad=PAD, depth=depth,
            axis_name=None, refine=True))[0]
    n1, n2 = (h // SIZE) * (w // SIZE), (h // SIZE2) * (w // SIZE2)
    return np.split(packed, np.cumsum([n1, n2, n1, n1, n2]))


def _port_tables(orig, refp, r, depth):
    h, w = orig.shape
    o, rp = torch.from_numpy(orig), torch.from_numpy(refp)
    out = []
    for size, rr in ((SIZE, r), (SIZE2, min(r, 16))):
        kw = dict(size=size, r=rr, ny=h // size, nx=w // size, pad=PAD,
                  depth=depth)
        idx = me_ssd.me_idx_frame(o, rp, me_ssd._bits0_dev(rr, o.device), 1,
                                  **kw)
        out.append((idx, *me_ssd.refine_tables(o, rp, idx, **kw)))
    (i1, o1, h1), (i2, o2, h2) = out
    return [t.numpy() for t in (i1, i2, o1, h1, o2, h2)]


@pytest.mark.parametrize("depth,r", [(8, 8), (10, 8), (8, 78), (10, 78)])
def test_refine_tables_equal_reference(depth, r):
    """Both grids' indices and tables equal hevc_tpu's; at r = 78 the
    search reaches MVs whose tiles start outside the 80-sample pad's phase
    planes, where XLA clamps the slice starts."""
    orig, refp = _planes(depth)
    ref = _jax_tables(orig, refp, r, depth)
    got = _port_tables(orig, refp, r, depth)
    for name, a, b in zip(("i1", "i2", "off1", "half1", "off2", "half2"),
                          got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(np.unique(np.r_[got[2], got[4]])) >= 4  # many offsets


@pytest.mark.parametrize("depth", [8, 10, 12, 14])
def test_phases_and_satd_equal_reference(depth):
    rng = np.random.default_rng(depth)
    refp = rng.integers(0, 1 << depth, (40, 56)).astype(np.int32)
    got = me_ssd._build_phases_plain(torch.from_numpy(refp), depth)
    with no_jax_cache_writes():
        ref = np.asarray(me_mxu._build_phases(jnp.asarray(refp), depth))
    np.testing.assert_array_equal(got.numpy(), ref)
    for size in (4, 8, 16, 32):
        ob, tiles = rng.integers(0, 1 << depth, (2, 5, size, size)).astype(
            np.int32)
        with no_jax_cache_writes():
            ref = np.asarray(me_mxu._satd_of_tiles(jnp.asarray(ob),
                                                   jnp.asarray(tiles), size))
        np.testing.assert_array_equal(
            me_ssd._satd_of_tiles_plain(torch.from_numpy(ob),
                                        torch.from_numpy(tiles), size), ref)


@pytest.mark.parametrize("size", [SIZE, SIZE2])
def test_refine_clamped_tiles_at_window_corners(size):
    """Every block at one of the nine corner and edge MVs of r = 78 (the
    tile starts leave the phase planes on every side): _refine_direct_plain
    against the reference's _refine_direct on the same phase planes."""
    r, depth = 78, 8
    orig, refp = _planes(depth)
    h, w = orig.shape
    ny, nx = h // size, w // size
    nyx = 2 * r + 1
    mv = [(-r, -r), (-r, 0), (-r, r), (0, -r), (0, 0), (0, r), (r, -r),
          (r, 0), (r, r)]
    gidx = np.array([(mv[b % 9][0] + r) * nyx + mv[b % 9][1] + r
                     for b in range(ny * nx)], np.int32)
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=PAD)
    phases = me_ssd._build_phases_plain(torch.from_numpy(refp), depth)
    got = me_ssd._refine_direct_plain(torch.from_numpy(orig), phases,
                                      torch.from_numpy(gidx), **kw)
    with no_jax_cache_writes():
        ref = jax.jit(me_mxu._refine_direct, static_argnames=tuple(kw))(
            jnp.asarray(orig), jnp.asarray(phases.numpy()),
            jnp.asarray(gidx), **kw)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _host_refine(orig, refp, mvx, mvy, bx, by, size, depth):
    """The engine's two-stage refinement and 3x3 half minimum
    (engine.cpp cost_of), replayed from the port's host twins."""
    from hevc_tpu_torch.encoder.intra_frame import satd
    from hevc_tpu_torch.ops.interp import mc_predict_np
    ob = orig[by:by + size, bx:bx + size]

    def cost(qx, qy):
        return satd(ob, mc_predict_np(refp, PAD, qx, qy, bx, by, size, size,
                                      depth, True))
    rmx, rmy = mvx * 4, mvy * 4
    best = cost(rmx, rmy)
    for step in (2, 1):
        cx0, cy0 = rmx, rmy
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                if dx == 0 and dy == 0:
                    continue
                c = cost(cx0 + dx, cy0 + dy)
                if c < best:
                    best, rmx, rmy = c, cx0 + dx, cy0 + dy
    half_min = min(cost(mvx * 4 + dx, mvy * 4 + dy)
                   for dy in (-2, 0, 2) for dx in (-2, 0, 2))
    return rmx - mvx * 4, rmy - mvy * 4, half_min


@pytest.mark.parametrize("depth", [8, 10])
def test_refine_tables_match_host_replay(depth):
    orig, refp = _planes(depth)
    i1, i2, o1, h1, o2, h2 = _port_tables(orig, refp, 8, depth)
    nx = {SIZE: orig.shape[1] // SIZE, SIZE2: orig.shape[1] // SIZE2}
    for idx, offs, halfs, size in ((i1, o1, h1, SIZE), (i2, o2, h2, SIZE2)):
        for b in range(len(idx)):
            mvy, mvx = idx[b] // 17 - 8, idx[b] % 17 - 8
            bx, by = (b % nx[size]) * size, (b // nx[size]) * size
            edx, edy, ehalf = _host_refine(orig.astype(np.int32),
                                           refp.astype(np.int32), mvx, mvy,
                                           bx, by, size, depth)
            assert offs[b] == (edy + 3) * 7 + (edx + 3), (size, b)
            assert halfs[b] == ehalf, (size, b)


W, H, N = 192, 128, 5


def _cfg():
    cfg = jax_parse_cfg_file(LDP_CFG, JaxEncoderConfig())
    cfg.width, cfg.height, cfg.frames_to_encode = W, H, N
    cfg.search_range = 16
    return cfg


def _port_encode(monkeypatch, refine, prefilter):
    """The port's LDP encode on the CPU; returns (stream, refine_tables
    calls)."""
    monkeypatch.setenv("HEVC_TPU_ME_REFINE", refine)
    monkeypatch.setenv("HEVC_TPU_ME_PREFILTER_REF", prefilter)
    calls = []
    real = me_ssd.refine_tables

    def spy(*a, **k):
        calls.append(k["size"])
        return real(*a, **k)
    monkeypatch.setattr(me_ssd, "refine_tables", spy)
    enc = EncoderTop(config_from_reference(dataclasses.asdict(_cfg())),
                     device="cpu")
    frames = moving_frames(N, W, H, seed=3)
    out = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    monkeypatch.setattr(me_ssd, "refine_tables", real)
    return out, calls


@pytest.mark.parametrize("prefilter", ["0", "1"])
def test_refine_encode_stream_identical(monkeypatch, prefilter):
    """HEVC_TPU_ME_REFINE=1 under both prefilter settings: the port's
    stream equals hevc_tpu's, whose device program runs on JAX-CPU
    (HEVC_TPU_ME_PREFETCH_CPU=1); the tables of both grids were made for
    every P picture, and every hash checks."""
    got, calls = _port_encode(monkeypatch, "1", prefilter)
    monkeypatch.setenv("HEVC_TPU_ME_PREFETCH_CPU", "1")
    with no_jax_cache_writes():
        enc = JaxEncoderTop(_cfg())
        ref = b"".join(enc.encode_frame(f)
                       for f in moving_frames(N, W, H, seed=3)) + enc.flush()
    assert len(got) > 0 and got == ref
    assert calls.count(SIZE) >= N - 1 and calls.count(SIZE2) >= N - 1
    dec = DecoderTop()
    assert sum(1 for _ in dec.decode_stream(got)) == N
    assert dec.hash_status == ["OK"] * N


def test_refine_on_equals_off_with_prefilter_off(monkeypatch):
    """With the lookahead on the final references
    (HEVC_TPU_ME_PREFILTER_REF=0) the tables give the host loops'
    decisions: the stream is the same with them on and off."""
    on, calls = _port_encode(monkeypatch, "1", "0")
    off, none = _port_encode(monkeypatch, "0", "0")
    assert calls and not none
    assert len(on) > 0 and on == off
