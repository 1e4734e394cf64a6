"""The multi-device search and clip encode (hevc_tpu_torch.parallel) against
hevc_tpu.parallel on its 8-device CPU mesh (tests/conftest.py), on the CPU:
the frame-axis and block-axis grids equal the reference's and the port's
unsharded search's, uneven shards included (more devices than frames or
block rows), and encode_clip's streams (low-delay P, its lookahead mode,
random access) are byte-identical to the reference's and decode with every
MD5 SEI "OK". Mirrors tests/test_parallel.py."""
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from hevc_tpu import parallel as jax_parallel
from hevc_tpu.io.cfg import EncoderConfig as JaxEncoderConfig
from hevc_tpu.io.cfg import parse_cfg_file as jax_parse_cfg_file
from hevc_tpu_torch import parallel
from hevc_tpu_torch.decoder.top import DecoderTop
from hevc_tpu_torch.encoder.native_frame import PAD, batched_me_grid
from hevc_tpu_torch.io.cfg import config_from_reference
from hevc_tpu_torch.ops import me_ssd
from hevc_tpu_torch.ops.interp import pad_plane
from test_torch_helpers import (CFG_DIR, no_jax_cache_writes,
                                one_torch_thread,  # noqa: F401
                                private_reference_native)  # noqa: F401


def _frames(n, w, h, seed=3):
    """tests/test_parallel.py's content: random texture moving by (2, 1)
    samples a frame."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(h + 16, w + 16)).astype(np.int16)
    out = []
    for t in range(n):
        y = base[t:t + h, 2 * t:2 * t + w].copy()
        u = (y[::2, ::2] // 2 + 32).astype(np.int16)
        v = (y[1::2, ::2] // 2 + 48).astype(np.int16)
        out.append([y, u, v])
    return out


def _jax_mesh():
    return JaxMesh(np.array(jax.devices()[:8]), ("frame",))


@pytest.mark.parametrize("n_frames,n_dev", [(5, 8), (5, 3), (9, 2)])
def test_me_grids_frames_equal_reference(n_frames, n_dev):
    """Frames over a mesh of n_dev CPU devices (uneven chunks, padded with
    the last frame) and unsharded equal the reference's 8-device grids and
    the port's per-frame search."""
    frames = _frames(n_frames, 96, 64)
    size, r, lam = 32, 8, 7_000
    origs = np.stack([f[0] for f in frames[1:]])
    refs = np.stack([pad_plane(f[0], PAD) for f in frames[:-1]])
    with no_jax_cache_writes():
        jx, jy = jax_parallel.me_grids_frames(
            origs, refs, size=size, search_range=r, lam_fp=lam,
            mesh=_jax_mesh())
    kw = dict(size=size, search_range=r, lam_fp=lam)
    mesh = parallel.make_mesh(n_dev, device="cpu")
    for got in (parallel.me_grids_frames(origs, refs, device="cpu", **kw),
                parallel.me_grids_frames(origs, refs, mesh=mesh, **kw)):
        np.testing.assert_array_equal(got[0], jx)
        np.testing.assert_array_equal(got[1], jy)
    for i in range(len(origs)):
        ex, ey = batched_me_grid(origs[i], refs[i], size, r, lam,
                                 device="cpu")
        np.testing.assert_array_equal(jx[i], ex)
        np.testing.assert_array_equal(jy[i], ey)


@pytest.mark.parametrize("w,h,n_dev", [(128, 96, 8), (160, 224, 3),
                                       (160, 224, 7)])
def test_me_grid_spatial_equal_reference(w, h, n_dev):
    """One frame's block rows over n_dev shards (3 rows over 8 shards;
    7 rows over 3 and over 7) equal the reference's sharded grid and the
    unsharded search."""
    frames = _frames(2, w, h)
    size, r, lam = 32, 8, 12_000
    ref = pad_plane(frames[0][0], PAD)
    with no_jax_cache_writes():
        jx, jy = jax_parallel.me_grid_spatial(
            frames[1][0], ref, size=size, search_range=r, lam_fp=lam,
            mesh=_jax_mesh())
    gx, gy = parallel.me_grid_spatial(
        frames[1][0], ref, size=size, search_range=r, lam_fp=lam,
        mesh=parallel.make_mesh(n_dev, device="cpu"))
    ex, ey = batched_me_grid(frames[1][0], ref, size, r, lam, device="cpu")
    for a, b, c in ((gx, jx, ex), (gy, jy, ey)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _banded(depth, h=176, w=160):
    """orig and two padded references at `depth` bits: random samples, one
    reference moving by (2, -1) and one whose 32-row bands move by 0, 11
    and -11 samples in turn, so that a block's own minimum often lies
    beyond the local window around its neighbourhood's (the case
    HEVC_TPU_ME_LOCAL_ONLY decides)."""
    import torch
    rng = np.random.default_rng(depth)
    base = rng.integers(0, 1 << depth, (h + 32, w + 32))
    orig = base[16:16 + h, 16:16 + w]
    banded = orig.copy()
    for k, y0 in enumerate(range(0, h, 32)):
        s = (0, 11, -11)[k % 3]
        banded[y0:y0 + 32] = base[16 + y0:16 + y0 + 32,
                                  16 + s:16 + s + w][:min(32, h - y0)]
    dt = me_ssd.me_dtype(depth)
    refs = [me_ssd.pad_ref_device(torch.from_numpy(r.astype(dt)), PAD)
            for r in (base[14:14 + h, 17:17 + w], banded)]
    return torch.from_numpy(orig.astype(dt)), refs


def _equal(got, exp):
    for a, b in zip(got, exp):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("depth", [8, 10, 16])
@pytest.mark.parametrize("n_dev", [2, 5])
def test_mesh_search_equals_unsharded(monkeypatch, depth, n_dev):
    """me_grids_multi2 over a mesh (both grids, two references, weighted
    prediction on one) equals the unsharded search at 8, 10 and 16 bits.
    HEVC_TPU_ME_LOCAL_ONLY is fixed per search shape when first read: the
    shards read it under the whole frame's shape, so a flag set later
    changes the sharded search no more than the unsharded one (and here
    the flag, read anew, would change the grids)."""
    orig, refs = _banded(depth)
    mesh = parallel.make_mesh(n_dev, device="cpu")
    for wp in (None, [None, (40, 2, 6)]):
        exp = me_ssd.me_grids_multi2(orig, refs, 32, 16, 12, 20_000,
                                     pad=PAD, depth=depth, wp=wp)
        _equal(me_ssd.me_grids_multi2(orig, refs, 32, 16, 12, 20_000,
                                      pad=PAD, depth=depth, wp=wp,
                                      mesh=mesh), exp)
    kw = dict(pad=PAD, depth=depth)
    me_ssd._local_only.cache_clear()
    exp = me_ssd.me_grids_multi(orig, refs, 32, 12, 20_000, **kw)
    monkeypatch.setenv("HEVC_TPU_ME_LOCAL_ONLY", "1")
    _equal(me_ssd.me_grids_multi(orig, refs, 32, 12, 20_000, mesh=mesh,
                                 **kw), exp)
    me_ssd._local_only.cache_clear()
    flagged = me_ssd.me_grids_multi(orig, refs, 32, 12, 20_000, **kw)
    me_ssd._local_only.cache_clear()
    assert any((u != v).any() for a, b in zip(flagged, exp)
               for u, v in zip(a, b))


def _cfgs(ra: bool, w, h, n, qp):
    """The same configuration for both packages: random access from the
    port's encoder_randomaccess_main.cfg (SearchRange 64), or the default
    low-delay P configuration."""
    if ra:
        jcfg = jax_parse_cfg_file(f"{CFG_DIR}/encoder_randomaccess_main.cfg",
                                  JaxEncoderConfig())
        jcfg.width, jcfg.height, jcfg.frames_to_encode, jcfg.qp = w, h, n, qp
        assert jcfg.search_range == 64
    else:
        jcfg = JaxEncoderConfig(width=w, height=h, qp=qp, intra_period=-1,
                                frames_to_encode=n)
    return jcfg, config_from_reference(dataclasses.asdict(jcfg))


def _decodes(data, n):
    dec = DecoderTop()
    assert sum(1 for _ in dec.decode_stream(data)) == n
    assert dec.hash_status == ["OK"] * n


@pytest.mark.parametrize("mode,w,h,n,seed", [
    ("ldp", 128, 80, 5, 3), ("ldp_lookahead", 96, 64, 4, 11),
    ("ra", 96, 64, 9, 5)])
def test_encode_clip_equal_reference(monkeypatch, mode, w, h, n, seed):
    """encode_clip over an 8-device CPU mesh: byte-identical to
    hevc_tpu.parallel.encode_clip on its 8-device mesh; the product modes
    also to the port's unsharded encode with HEVC_TPU_ME_PREFETCH=0 (a mesh
    runs no one-frame lookahead, as in the reference); every hash "OK"."""
    frames = _frames(n, w, h, seed=seed)
    jcfg, cfg = _cfgs(mode == "ra", w, h, n, 32 if mode != "ldp" else 30)
    lookahead = mode == "ldp_lookahead"
    with no_jax_cache_writes():
        ref, _ = jax_parallel.encode_clip(jcfg, frames, mesh=_jax_mesh(),
                                          lookahead=lookahead)
    got, stats = parallel.encode_clip(
        cfg, frames, mesh=parallel.make_mesh(8, device="cpu"),
        lookahead=lookahead)
    assert len(stats) == n
    assert len(got) > 0 and got == ref
    if not lookahead:
        monkeypatch.setenv("HEVC_TPU_ME_PREFETCH", "0")
        plain, _ = parallel.encode_clip(cfg, frames, device="cpu")
        assert plain == got
    _decodes(got, n)


def test_mesh_entry_points_refuse():
    """make_mesh raises where fewer cards are present than asked for (here
    none); the lookahead mode refuses a reordered GOP; the encoder runs on
    the mesh's first device and refuses another."""
    with pytest.raises(RuntimeError):
        parallel.make_mesh(2, device="cuda")
    with pytest.raises(ValueError):
        parallel.make_mesh(0, device="cpu")
    frames = _frames(3, 64, 64)
    _, cfg = _cfgs(True, 64, 64, 3, 32)
    mesh = parallel.make_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        parallel.encode_clip(cfg, frames, mesh=mesh, lookahead=True)
    with pytest.raises(ValueError):
        parallel.encode_clip(cfg, frames, mesh=mesh, device="cuda")
    from hevc_tpu_torch.encoder.top import EncoderTop
    assert EncoderTop(cfg, mesh=mesh).device.type == "cpu"
