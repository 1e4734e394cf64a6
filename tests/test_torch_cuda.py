"""hevc_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card (exact integer equality), and a small encode on the card against
the same encode on the CPU. Marked `cuda`; each test skips where no card
is present. The machine with the card has no JAX, so run these there
without the repository's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import (LDP_CFG, SAD_KINDS, SAD_SHAPES,
                                SEARCH_KINDS, SEARCH_LAMS, at_depth,
                                cost_table, moving_frames, planes_case,
                                sad_range_case, search_case)

pytestmark = pytest.mark.cuda
PAD = 80


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eq(a, b):
    torch.cuda.synchronize()
    np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("n,h,w,R", [(2, 8, 8, 2), (5, 16, 16, 4),
                                     (3, 8, 16, 3), (7, 32, 32, 64)])
def test_sad_kernels_match_plain(dev, n, h, w, R):
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import sad
    rng = np.random.default_rng(n + h)
    blks = torch.from_numpy(rng.integers(0, 256, (n, h, w)).astype(
        np.int32)).to(dev)
    areas = torch.from_numpy(rng.integers(
        0, 256, (n, h + 2 * R, w + 2 * R)).astype(np.int32)).to(dev)
    before = runtime.launches["sad_table"]
    got = sad.sad_table(blks, areas)
    assert runtime.launches["sad_table"] == before + 1
    _eq(got, sad.sad_table_plain(blks, areas))
    mins = torch.full((n,), -R, dtype=torch.int32, device=dev)
    py = torch.from_numpy(rng.integers(-8, 8, n).astype(np.int32)).to(dev)
    px = torch.from_numpy(rng.integers(-8, 8, n).astype(np.int32)).to(dev)
    for sads in (got, torch.zeros_like(got)):      # zeros: all ties
        k = sad.cost_argmin(sads, mins, mins, py, px, 40000)
        p = sad.cost_argmin_plain(sads, mins, mins, py, px, 40000)
        for a, b in zip(k, p):
            _eq(a, b)


@pytest.mark.parametrize("h,w,ny,nx", SAD_SHAPES + [(32, 32, 129, 129)])
@pytest.mark.parametrize("kind", SAD_KINDS)
def test_sad_table_sample_ranges(dev, kind, h, w, ny, nx):
    """sad_table against its plain version at every sample range its
    kernel branches on: 8-bit samples with 0 and 255 at the extremes
    (8-bit path), 10-14 bits (float path where h * w * max < 2^24, int32
    path past it), 16 bits, negative values up to +-2^28 whose sums wrap in
    int32, and one launch whose blocks mix every range; non-square blocks
    and searches (ny, nx of 3, 5, 7), 64 x 64 blocks at R = 1 .. 4, the
    fallback path's 32 x 32 at R = 64, an odd N."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import sad
    blks, areas = sad_range_case(kind, 7, h, w, ny, nx, seed=h * ny + nx)
    b = torch.from_numpy(blks).to(dev)
    a = torch.from_numpy(areas).to(dev)
    before = runtime.launches["sad_table"]
    got = sad.sad_table(b, a)
    assert runtime.launches["sad_table"] == before + 1
    _eq(got, sad.sad_table_plain(b, a))


@pytest.mark.parametrize("n", [1, 7])
@pytest.mark.parametrize("h,w,ny,nx", SAD_SHAPES + [(32, 32, 129, 129),
                                                   (6, 10, 5, 7),
                                                   (7, 9, 3, 3)])
@pytest.mark.parametrize("kind", SEARCH_KINDS)
def test_full_search_kernel_matches_plain(dev, kind, h, w, ny, nx, n):
    """The fused full search (one launch, no table) against its plain
    version on all four outputs: every sample range ("mixed" puts the
    8-bit, float and int32 sweeps in one launch), all-ties blocks, the
    fallback path's 32 x 32 at R = 64, block sides that are no multiple
    of 4, N = 1 and odd N with two zero bucket-padding rows, per-block
    mv_min and predictors that are not zero, lam_fp products that wrap.
    sad_table and sad_cost_argmin are not launched on this route."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me, sad
    args = [torch.from_numpy(a).to(dev) for a in search_case(
        kind, n, h, w, ny, nx, seed=h * ny + nx, padding=2 if n > 1 else 0)]
    for lam_fp in SEARCH_LAMS:
        before = dict(runtime.launches)
        got = sad.full_search_batch_kernel(*args, lam_fp)
        assert runtime.launches["full_search"] == before["full_search"] + 1
        for k in ("sad_table", "sad_cost_argmin"):
            assert runtime.launches[k] == before[k]
        exp = me.full_search_batch(*args, lam_fp)
        for a, b in zip(got, exp):
            assert a.dtype == b.dtype and a.shape == b.shape
            _eq(a, b)


@pytest.mark.parametrize("n,ny,nx", [(1, 1, 1), (1, 129, 129), (7, 5, 5),
                                     (7, 3, 7), (5, 2, 3), (3, 1, 9),
                                     (9, 33, 31), (128, 129, 129),
                                     (6, 4, 4)])
@pytest.mark.parametrize("table", ["random", "flat", "huge"])
def test_cost_argmin_kernel_matches_plain(dev, table, n, ny, nx):
    """sad_cost_argmin against its plain version: ties everywhere
    ("flat"), SADs near INT32_MAX whose cost wraps ("huge"), N = 1, odd
    ny * nx (block tables that start at every 16-byte misalignment; the
    table from its second block on starts off alignment too), tables
    shorter than one 16-byte load, and the 1080p shape's 129 x 129."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import sad
    sads = torch.from_numpy(cost_table(table, n, ny, nx, seed=n + ny * nx)
                            ).to(dev)
    _, _, *vecs = search_case("8bit", n, 4, 4, ny, nx, seed=ny + nx)
    vecs = [torch.from_numpy(v).to(dev) for v in vecs]
    for lam_fp in SEARCH_LAMS:
        for lo in range(min(n, 2)):    # the whole table, then from block 1
            t, v = sads[lo:], [x[lo:] for x in vecs]
            before = runtime.launches["sad_cost_argmin"]
            got = sad.cost_argmin(t, *v, lam_fp)
            assert runtime.launches["sad_cost_argmin"] == before + 1
            for a, b in zip(got, sad.cost_argmin_plain(t, *v, lam_fp)):
                _eq(a, b)


@pytest.mark.parametrize("kind", ["moving", "flat"])
@pytest.mark.parametrize("size,r", [(32, 8), (16, 8), (16, 16), (32, 64)])
def test_me_kernels_match_plain(dev, kind, size, r):
    from hevc_tpu_torch.ops import me_ssd
    w, h = 128, 96
    if kind == "flat":
        orig = np.full((h, w), 128, np.uint8)
        ref = np.full((h, w), 128, np.uint8)
    else:
        f = moving_frames(2, w, h, seed=size + r)
        orig, ref = f[1][0], f[0][0]
    o = torch.from_numpy(orig).to(dev)
    refp = me_ssd.pad_ref_device(torch.from_numpy(ref).to(dev), PAD)
    ny, nx = h // size, w // size
    aw = 2 * r + size
    roi = refp[PAD - r:PAD - r + (ny - 1) * size + aw,
               PAD - r:PAD - r + (nx - 1) * size + aw]
    kw = dict(size=size, r=r, ny=ny, nx=nx)
    ssd = me_ssd._ssd_table(roi, o, **kw)
    _eq(ssd, me_ssd._ssd_table_plain(roi, o, **kw))
    bits0 = me_ssd._bits0_dev(r, dev)
    lam_q8 = me_ssd.lam_q8_of(120000)
    _eq(me_ssd._argmin_two_pass(ssd, bits0, lam_q8, r=r, ny=ny, nx=nx,
                                size=size),
        me_ssd._argmin_two_pass_plain(ssd, bits0, lam_q8, r=r, ny=ny, nx=nx,
                                      local_only=False))


def _edge_planes(kind, h, w, seed):
    """orig and reference planes whose centred samples reach -128 and 127."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.integers(0, 256, (h, w)).astype(np.uint8),
                rng.integers(0, 256, (h, w)).astype(np.uint8))
    lo, hi = np.zeros((h, w), np.uint8), np.full((h, w), 255, np.uint8)
    return {"zeros": (lo, lo), "full": (hi, hi), "zeros_vs_full": (lo, hi),
            "full_vs_zeros": (hi, lo)}[kind]


@pytest.mark.parametrize("kind", ["random", "zeros", "full", "zeros_vs_full",
                                  "full_vs_zeros"])
@pytest.mark.parametrize("r", [1, 3, 16, 64])
@pytest.mark.parametrize("size", [8, 16, 32])
def test_ssd_table_edge_shapes(dev, size, r, kind):
    """The tensor-core SSD table equals its plain version on grids and
    offset counts that are no multiple of its tiles, and at the extreme
    samples (all 0 / all 255)."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    ny, nx = 3, 5
    orig, ref = _edge_planes(kind, ny * size + 2, nx * size + 3,
                             seed=size * 100 + r)
    o = torch.from_numpy(orig).to(dev)
    refp = me_ssd.pad_ref_device(torch.from_numpy(ref).to(dev), PAD)
    aw = 2 * r + size
    roi = refp[PAD - r:PAD - r + (ny - 1) * size + aw,
               PAD - r:PAD - r + (nx - 1) * size + aw]
    kw = dict(size=size, r=r, ny=ny, nx=nx)
    before = runtime.launches["ssd_table"]
    got = me_ssd._ssd_table(roi, o, **kw)
    assert runtime.launches["ssd_table"] == before + 1
    _eq(got, me_ssd._ssd_table_plain(roi, o, **kw))


@pytest.mark.parametrize("kind", ["random", "zeros", "full"])
@pytest.mark.parametrize("size,h,w", [(8, 8, 8), (16, 47, 301), (32, 200, 133),
                                      (32, 1216, 2048), (8, 38, 250),
                                      (16, 41, 129), (32, 79, 260),
                                      (32, 33, 35), (16, 1104, 1952)])
def test_box_energies_match_plain(dev, size, h, w, kind):
    """The window-energy kernel equals the torch integral image, on planes
    whose output is no multiple of its 16-row band or its 128 - size
    column strip (and of 4 columns), on a row-strided view that starts at
    an odd column, and at the 16x16 grid's 1080p shape."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    plane, _ = _edge_planes(kind, h + 5, w + 9, seed=h + w)
    p = torch.from_numpy(plane).to(dev)[3:3 + h, 7:7 + w]
    before = runtime.launches["box_energies"]
    got = me_ssd.box_energies(p, size)
    assert runtime.launches["box_energies"] == before + 1
    assert got.shape == (h - size + 1, w - size + 1)
    rc = p.to(torch.int32) - 128
    _eq(got, me_ssd._box_energies(rc * rc, size))


def _deep_planes(kind, h, w, bit_depth, seed):
    """orig and reference int16 planes of bit_depth-bit samples, each a view
    that starts at an odd column of a larger plane: random over the whole
    range, the range's two ends against each other, or moving texture with
    flat patches (many offsets tie)."""
    rng = np.random.default_rng(seed)
    top = (1 << bit_depth) - 1
    if kind == "random":
        planes = [rng.integers(0, top + 1, (h, w)) for _ in range(2)]
    elif kind == "zeros_vs_max":
        planes = [np.zeros((h, w)), np.full((h, w), top)]
    else:
        f = moving_frames(2, w, h, seed=seed)
        planes = [f[1][0].astype(np.int64) << (bit_depth - 8),
                  f[0][0].astype(np.int64) << (bit_depth - 8)]
        for p in planes:
            p[:h // 2, :w // 3] = top // 3
    out = []
    for p in planes:
        big = np.zeros((h + 3, w + 4), np.int16)
        big[2:2 + h, 1:1 + w] = p
        out.append((big, h, w))
    return out


def _deep_view(dev, big, h, w):
    return torch.from_numpy(big).to(dev)[2:2 + h, 1:1 + w]


@pytest.mark.parametrize("kind", ["random", "zeros_vs_max", "flat"])
@pytest.mark.parametrize("bit_depth", [9, 10, 12, 14])
@pytest.mark.parametrize("r", [1, 3, 16, 64])
@pytest.mark.parametrize("size", [8, 16, 32])
def test_ssd_table_deep_matches_plain(dev, size, r, bit_depth, kind):
    """The deep SSD table (three int8 tensor-core products, its box plane
    from box_energies_deep) equals its plain version at every block size,
    on a 3 x 5 grid (odd ny and nx, offsets no multiple of the tiles),
    with orig and roi strided views into larger planes, at 9 to 14 bits,
    at the samples' extremes and on flat patches."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    ny, nx = 3, 5
    orig, ref = _deep_planes(kind, ny * size + 2, nx * size + 3, bit_depth,
                             seed=size * 100 + r + bit_depth)
    o = _deep_view(dev, *orig)
    refp = me_ssd.pad_ref_device(_deep_view(dev, *ref), PAD)
    aw = 2 * r + size
    roi = refp[PAD - r:PAD - r + (ny - 1) * size + aw,
               PAD - r:PAD - r + (nx - 1) * size + aw]
    kw = dict(size=size, r=r, ny=ny, nx=nx, depth=bit_depth)
    before = dict(runtime.launches)
    got = me_ssd._ssd_table_deep(roi, o, **kw)
    for k in ("ssd_table_deep", "box_energies_deep"):
        assert runtime.launches[k] == before[k] + 1
    for k in ("ssd_table", "box_energies"):
        assert runtime.launches[k] == before[k]
    _eq(got, me_ssd._ssd_table_deep_plain(roi, o, **kw))


def _check_deep_table(dev, size, r, ny, nx, bit_depth, kind, seed):
    """One _ssd_table_deep call on strided int16 views: one launch of the
    deep kernel (and of box_energies_deep, none of the 8-bit kernels) and
    a table equal to the plain version's."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    orig, ref = _deep_planes(kind, ny * size + 2, nx * size + 3, bit_depth,
                             seed=seed)
    o = _deep_view(dev, *orig)
    refp = me_ssd.pad_ref_device(_deep_view(dev, *ref), PAD)
    aw = 2 * r + size
    roi = refp[PAD - r:PAD - r + (ny - 1) * size + aw,
               PAD - r:PAD - r + (nx - 1) * size + aw]
    kw = dict(size=size, r=r, ny=ny, nx=nx, depth=bit_depth)
    before = dict(runtime.launches)
    got = me_ssd._ssd_table_deep(roi, o, **kw)
    for k in ("ssd_table_deep", "box_energies_deep"):
        assert runtime.launches[k] == before[k] + 1
    for k in ("ssd_table", "box_energies"):
        assert runtime.launches[k] == before[k]
    _eq(got, me_ssd._ssd_table_deep_plain(roi, o, **kw))


@pytest.mark.parametrize("kind", ["random", "zeros_vs_max"])
@pytest.mark.parametrize("r", [7, 8, 15, 23, 24, 31, 32])
@pytest.mark.parametrize("size", [8, 16, 32])
def test_ssd_table_deep_tile_edges(dev, size, r, kind):
    """r on the deep kernel's tile edges at 14 bits (the largest |corr|):
    2r + 1 one short of a 16-row tile (7, 15, 23, 31) or one past it, where
    the last tile is packed (8, 24, 32), and at the ends of the groups of
    n8 tiles (15, 23, 31 and 16 at 32x32, 23 and 24 at 16x16)."""
    _check_deep_table(dev, size, r, 3, 5, 14, kind, seed=size * 7 + r)


@pytest.mark.parametrize("kind,bit_depth", [("random", 10), ("random", 14),
                                            ("zeros_vs_max", 14)])
@pytest.mark.parametrize("size,r,ny,nx", [(32, 64, 17, 20), (16, 16, 34, 40),
                                          (8, 8, 40, 40)])
def test_ssd_table_deep_many_blocks(dev, size, r, ny, nx, kind, bit_depth):
    """Grids of more search blocks than the card holds at once (two thread
    blocks an SM at 32x32, five at 16x16 and 8x8: 264 and 660 on 132 SMs),
    so that thread blocks run in several waves and reuse shared memory
    that earlier blocks left behind."""
    _check_deep_table(dev, size, r, ny, nx, bit_depth, kind,
                      seed=ny * nx + bit_depth)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16])
def test_pad_ref_device_on_card(dev, dtype):
    """The reference padding (one F.pad(mode="replicate")) on the card
    equals numpy's edge padding, a pad wider than the plane included."""
    from hevc_tpu_torch.ops import me_ssd
    rng = np.random.default_rng(3)
    for h, w, pad in ((1080, 1920, 80), (7, 5, 80)):
        plane = rng.integers(0, 256 if dtype == np.uint8 else 1024,
                             (h, w)).astype(dtype)
        got = me_ssd.pad_ref_device(torch.from_numpy(plane).to(dev), pad)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      np.pad(plane, pad, mode="edge"))


@pytest.mark.parametrize("kind", ["random", "zeros_vs_max", "flat"])
@pytest.mark.parametrize("bit_depth", [10, 12, 14])
@pytest.mark.parametrize("size,h,w", [(8, 8, 8), (16, 47, 301), (32, 200, 133),
                                      (8, 38, 250), (32, 79, 260),
                                      (16, 1104, 1952), (32, 1184, 2048)])
def test_box_energies_deep_match_plain(dev, size, h, w, bit_depth, kind):
    """The deep window-energy kernel equals the torch integral image of the
    centred squares on int16 views that start at an odd column, on planes
    whose output is no multiple of its band, strip or 4 columns, and at the
    1080p shapes of both grids."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    plane, _ = _deep_planes(kind, h, w, bit_depth, seed=h + w + bit_depth)
    p = _deep_view(dev, *plane)
    shift, mid = me_ssd.deep_centring(bit_depth)
    before = runtime.launches["box_energies_deep"]
    got = me_ssd.box_energies(p, size, shift, mid)
    assert runtime.launches["box_energies_deep"] == before + 1
    assert got.shape == (h - size + 1, w - size + 1)
    rc = (p.to(torch.int32) >> shift) - mid
    _eq(got, me_ssd._box_energies(rc * rc, size))


def test_deep_kernels_reject_bad_arguments(dev):
    """No fallback on the card: a wrong dtype, layout, size, depth or
    centring raises before any launch."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    size, r, ny, nx = 16, 4, 2, 3
    aw = 2 * r + size
    roi = torch.zeros(((ny - 1) * size + aw, (nx - 1) * size + aw),
                      dtype=torch.int16, device=dev)
    orig = torch.zeros((ny * size, nx * size), dtype=torch.int16, device=dev)
    kw = dict(size=size, r=r, ny=ny, nx=nx, depth=10)
    before = dict(runtime.launches)
    bad = [
        lambda: me_ssd._ssd_table_deep(roi.to(torch.int32), orig, **kw),
        lambda: me_ssd._ssd_table_deep(roi, orig.to(torch.uint8), **kw),
        lambda: me_ssd._ssd_table_deep(roi[1:], orig, **kw),
        lambda: me_ssd._ssd_table_deep(roi, orig[:, 1:], **kw),
        lambda: me_ssd._ssd_table_deep(roi.t(), orig, **kw),
        lambda: me_ssd._ssd_table_deep(roi, orig, **dict(kw, depth=16)),
        lambda: me_ssd._ssd_table_deep(roi, orig, **dict(kw, size=4)),
        lambda: me_ssd.box_energies(roi.to(torch.int32), size, 0, 512),
        lambda: me_ssd.box_energies(roi.to(torch.uint8), size, 0, 512),
        lambda: me_ssd.box_energies(roi, size, 5, 512),
        lambda: me_ssd.box_energies(roi, 12, 0, 512),
        lambda: me_ssd.box_energies(roi[:, ::2], size, 0, 512),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert runtime.launches == before


@pytest.mark.parametrize("local_only", [False, True])
@pytest.mark.parametrize("table", ["random", "flat", "huge"])
@pytest.mark.parametrize("r,ny,nx", [(1, 1, 1), (3, 3, 5), (3, 9, 2),
                                     (16, 5, 9), (16, 4, 4), (64, 6, 7)])
def test_argmin_two_pass_edge_shapes(dev, monkeypatch, r, ny, nx, table,
                                     local_only):
    """The tiled two-pass argmin equals its plain version on grids that are
    no multiple of its 2 x 4 tile, on a flat table (all ties), on values
    near 1 << 30 (int32 wrap in the 3x3 sums, masked offsets winning the
    local minimum), with HEVC_TPU_ME_LOCAL_ONLY's branch on and off."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    monkeypatch.setattr(me_ssd, "_local_only", lambda *a: local_only)
    nyx = 2 * r + 1
    rng = np.random.default_rng(r * 31 + ny * nx)
    shape = (ny * nx, nyx, nyx)
    if table == "random":
        ssd = rng.integers(0, 1 << 20, shape)
    elif table == "flat":
        ssd = np.zeros(shape)
    else:
        ssd = rng.integers((1 << 30) - (1 << 16), (1 << 30) + (1 << 16),
                           shape)
    ssd = torch.from_numpy(ssd.astype(np.int32)).to(dev)
    bits0 = me_ssd._bits0_dev(r, dev)
    for lam_q8 in (1, me_ssd.lam_q8_of(120000), 1 << 20):
        before = runtime.launches["argmin_two_pass"]
        got = me_ssd._argmin_two_pass(ssd, bits0, lam_q8, r=r, ny=ny, nx=nx,
                                      size=16)
        assert runtime.launches["argmin_two_pass"] == before + 1
        _eq(got, me_ssd._argmin_two_pass_plain(
            ssd, bits0, lam_q8, r=r, ny=ny, nx=nx, local_only=local_only))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
@pytest.mark.parametrize("size,r,ny,nx,pad", [(8, 2, 3, 4, 4),
                                              (16, 4, 2, 5, 6),
                                              (32, 16, 3, 3, 16),
                                              (32, 64, 2, 3, 80)])
def test_planes_kernels_match_plain(dev, size, r, ny, nx, pad, dtype):
    """sad_table_planes and me_planes (one fused launch) against their plain
    versions, bucket padding included."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import sad
    rng = np.random.default_rng(size + r + ny)
    top = 256 if dtype == torch.uint8 else 1 << 14
    h, w = ny * size + 3, nx * size + 5
    ref = torch.from_numpy(rng.integers(0, top, (h + 2 * pad, w + 2 * pad))
                           ).to(dtype).to(dev)
    orig = torch.from_numpy(rng.integers(0, top, (h, w))).to(dtype).to(dev)
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=pad)
    before = dict(runtime.launches)
    got = sad.sad_table_from_planes(ref, orig, **kw)
    assert runtime.launches["sad_table_planes"] == \
        before["sad_table_planes"] + 1
    _eq(got, sad.sad_table_from_planes_plain(ref, orig, **kw))
    nyx = 2 * r + 1
    bits = torch.from_numpy(rng.integers(0, 40, (nyx, nyx)).astype(
        np.int32)).to(dev)
    for lam_fp in (0, 90000, -(1 << 30)):
        k = sad.me_from_planes(ref, orig, bits, lam_fp, **kw)
        _eq(k, sad.me_from_planes_plain(ref, orig, bits, lam_fp, **kw))
    assert runtime.launches["me_planes"] == before["me_planes"] + 3


@pytest.mark.parametrize("case", ["u8_view", "i16_10bit", "i16_15bit"])
@pytest.mark.parametrize("size,r,ny,nx,pad", [(8, 2, 3, 4, 4),
                                              (16, 4, 2, 5, 6),
                                              (32, 16, 3, 3, 16),
                                              (32, 64, 2, 3, 80)])
def test_planes_kernels_views_and_deep_samples(dev, size, r, ny, nx, pad,
                                               case):
    """The planes entries on uint8 planes that are views starting at an odd
    column with an odd row stride (windows at any byte offset), and on
    int16 planes of 10 bits (the float path) and 15 bits (float at 8 x 8
    and 16 x 16, int32 at 32 x 32), against their plain versions."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import sad
    ref, orig = planes_case(case, size, r, ny, nx, pad, seed=size + r + nx)
    ref, orig = (torch.from_numpy(big).to(dev)[y:y + hh, x:x + ww]
                 for big, (y, x, hh, ww) in (ref, orig))
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=pad)
    before = dict(runtime.launches)
    got = sad.sad_table_from_planes(ref, orig, **kw)
    assert runtime.launches["sad_table_planes"] == \
        before["sad_table_planes"] + 1
    _eq(got, sad.sad_table_from_planes_plain(ref, orig, **kw))
    nyx = 2 * r + 1
    rng = np.random.default_rng(size * r)
    bits = torch.from_numpy(rng.integers(0, 40, (nyx, nyx)).astype(
        np.int32)).to(dev)
    for lam_fp in (0, 90000, -(1 << 30)):
        k = sad.me_from_planes(ref, orig, bits, lam_fp, **kw)
        _eq(k, sad.me_from_planes_plain(ref, orig, bits, lam_fp, **kw))
    assert runtime.launches["me_planes"] == before["me_planes"] + 3


def _screen_plane(kind, h, w, bit_depth, seed):
    """An orig plane for the intra prescreen: random over the full range,
    flat (every mode ties), or textured with flat patches and a ramp."""
    rng = np.random.default_rng(seed)
    top = 1 << bit_depth
    if kind == "random":
        return rng.integers(0, top, (h, w)).astype(np.int16)
    if kind == "flat":
        return np.full((h, w), top // 3, np.int16)
    if kind == "max":
        return np.full((h, w), top - 1, np.int16)
    y = moving_frames(1, w, h, seed=seed)[0][0].astype(np.int16)
    y = y << (bit_depth - 8)
    y[:h // 2, :w // 3] = top // 5
    y[h // 2:, w // 2:] = (np.arange(w - w // 2) * (top // 256))[None, :]
    return y


@pytest.mark.parametrize("kind", ["random", "flat", "max", "mixed"])
@pytest.mark.parametrize("bit_depth", [8, 10, 12, 14])
@pytest.mark.parametrize("h,w", [(40, 72), (136, 200), (240, 416),
                                 (1080, 1920), (88, 136), (104, 168),
                                 (1120, 1952)])
def test_intra_screen_matches_plain(dev, h, w, bit_depth, kind):
    """The prescreen kernel (sizes 4 to 32, one launch each) against its
    plain version: frames whose 16x16 and 32x32 grids leave rows or columns
    uncovered (clamped references), whose block counts leave the last
    thread block of a size partly empty (168x104 at every size, 72x40,
    136x88 and 1952x1120 at some), 8 to 14 bits, flat planes where many modes tie, and mode costs that tie
    too."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import intra_screen
    y = _screen_plane(kind, h, w, bit_depth, seed=h + bit_depth)
    mid = 1 << (bit_depth - 1)
    p = np.full((h + 1, w + 1), mid, np.int16)
    p[1:, 1:] = y
    plane = torch.from_numpy(p).to(dev)
    rng = np.random.default_rng(w)
    for lam in (np.zeros(35), np.full(35, 7),
                [2, 3] + [6] * 24 + [3] + [6] * 8, rng.integers(0, 90, 35)):
        lam_tab = torch.tensor(np.asarray(lam, np.int32), device=dev)
        before = runtime.launches["intra_screen"]
        got = intra_screen.intra_screen(plane, lam_tab, bit_depth=bit_depth)
        assert runtime.launches["intra_screen"] == before + 4
        exp = intra_screen.intra_screen_plain(plane, lam_tab,
                                              bit_depth=bit_depth)
        for a, b in zip(got, exp):
            assert a.dtype == b.dtype and a.shape == b.shape
            _eq(a, b)


@pytest.mark.parametrize("cfg_name,bit_depth", [
    ("encoder_randomaccess_main10.cfg", 10),
    ("encoder_lowdelay_main.cfg", 8)])
def test_b_encode_on_card_matches_cpu(dev, cfg_name, bit_depth):
    """Random-access Main10 (the deep search kernels) and low-delay B, 9
    frames each: identical bytes on the card and on the CPU."""
    import os
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.encoder.top import EncoderTop
    from hevc_tpu_torch.io.cfg import EncoderConfig, parse_cfg_file
    from test_torch_helpers import CFG_DIR
    frames = [[at_depth(p, bit_depth) for p in f]
              for f in moving_frames(9, 128, 80, seed=8)]

    def run(device):
        cfg = parse_cfg_file(os.path.join(CFG_DIR, cfg_name),
                             EncoderConfig())
        cfg.width, cfg.height, cfg.frames_to_encode = 128, 80, 9
        cfg.input_bit_depth = bit_depth
        enc = EncoderTop(cfg, device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    before = dict(runtime.launches)
    got = run("cuda")
    key = "ssd_table_deep" if bit_depth > 8 else "ssd_table"
    assert runtime.launches[key] > before[key]
    assert got == run("cpu")


def test_encode_on_card_matches_cpu(dev):
    """The same LDP encode (prefetch off, then the CLI flow with the
    one-frame lookahead) on the card and on the CPU: identical bytes."""
    from hevc_tpu_torch.encoder.top import EncoderTop
    from hevc_tpu_torch.io.cfg import EncoderConfig, parse_cfg_file
    frames = moving_frames(6, 128, 80, seed=4)

    def run(device, prefetch):
        cfg = parse_cfg_file(LDP_CFG, EncoderConfig())
        cfg.width, cfg.height, cfg.frames_to_encode = 128, 80, 6
        enc = EncoderTop(dataclasses.replace(cfg), device=device)
        out = b""
        for i, f in enumerate(frames):
            if prefetch and i + 1 < len(frames):
                enc.prefetch_frame(frames[i + 1])
            out += enc.encode_frame(f)
        return out + enc.flush()
    for prefetch in (False, True):
        assert run("cuda", prefetch) == run("cpu", prefetch)


@pytest.mark.parametrize("depth", [8, 9, 10, 12, 14])
@pytest.mark.parametrize("h,w,view", [(1240, 2080, False), (37, 53, False),
                                      (64, 96, True)])
def test_wp_apply_matches_plain(dev, h, w, view, depth):
    """wp_apply against its plain version for every weight triple of the
    CPU tests (negative and zero weights, denom 0, the syntax's extremes):
    the 1080p padded plane, an odd size (the one-by-one tail), and a
    plane that starts at an odd offset (the unaligned path)."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    rng = np.random.default_rng(depth + h)
    dt = me_ssd.me_dtype(depth)
    big = torch.from_numpy(rng.integers(0, 1 << depth, h * w + 1).astype(
        dt)).to(dev)
    plane = (big[1:] if view else big[:-1]).view(h, w)
    for wpv in [(45, 12, 6), (64, 0, 6), (3, -10, 1), (1, 5, 0), (-20, 7, 3),
                (0, 9, 2), (-128, -128, 7), (255, 127, 7), (7, -3, 0)]:
        before = runtime.launches["wp_apply"]
        got = me_ssd.wp_apply(plane, wpv, depth)
        assert runtime.launches["wp_apply"] == before + 1
        assert got.dtype == plane.dtype and got.shape == plane.shape
        _eq(got, me_ssd.wp_apply_plain(plane, wpv, depth))


def _refine_planes(h, w, depth, seed):
    """orig and the padded reference (pad 80) for the refine kernel: a
    smooth texture and a blend of two displaced copies of it, with noise."""
    rng = np.random.default_rng(seed)
    top = 1 << depth
    t = rng.random((h + 16, w + 16))
    for axis in (0, 1):
        t = sum(np.roll(t, k, axis) for k in range(-2, 3)) / 5
    t = np.clip((t - t.mean()) * 6 + 0.5, 0, 1) * (top - 1)
    a = np.linspace(0, 1, w)[None]
    ref = a * t[6:6 + h, 5:5 + w] + (1 - a) * t[7:7 + h, 6:6 + w]
    ref += rng.integers(-2, 3, (h, w)) * (top >> 8)
    dt = np.uint8 if depth == 8 else np.int16
    refp = np.pad(np.clip(np.rint(ref), 0, top - 1), PAD, mode="edge")
    return np.rint(t[8:8 + h, 8:8 + w]).astype(dt), refp.astype(dt)


@pytest.mark.parametrize("depth", [8, 10, 12, 14])
@pytest.mark.parametrize("size,r,h,w", [(32, 8, 96, 160), (16, 16, 96, 160),
                                        (32, 64, 200, 264),
                                        (16, 16, 1080, 1920),
                                        (32, 78, 96, 160), (16, 78, 96, 160)])
@pytest.mark.parametrize("mvs", ["random", "edges"])
def test_refine_tables_match_plain(dev, size, r, h, w, depth, mvs):
    """refine_tables against its plain version: integer MVs at random or
    at the window's corners and edges (+-r); at r = 78 the tile starts
    leave the 80-sample pad's phase planes (the kernel's WIDE window);
    sizes 16 and 32, 8-14 bits, and the 1080p 16-grid."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    orig, refp = _refine_planes(h, w, depth, seed=size + r + depth)
    ny, nx = h // size, w // size
    nyx = 2 * r + 1
    rng = np.random.default_rng(r)
    if mvs == "random":
        gidx = rng.integers(0, nyx * nyx, ny * nx)
    else:
        ends = [(dy, dx) for dy in (-r, 0, r) for dx in (-r, 0, r)]
        gidx = np.array([(ends[b % 9][0] + r) * nyx + ends[b % 9][1] + r
                         for b in range(ny * nx)])
    o, rp = torch.from_numpy(orig).to(dev), torch.from_numpy(refp).to(dev)
    g = torch.from_numpy(gidx.astype(np.int32)).to(dev)
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=PAD, depth=depth)
    before = runtime.launches["refine_tables"]
    off, half = me_ssd.refine_tables(o, rp, g, **kw)
    assert runtime.launches["refine_tables"] == before + 1
    exp = me_ssd._refine_direct_plain(
        o, me_ssd._build_phases_plain(rp, depth), g, **{
            k: v for k, v in kw.items() if k != "depth"})
    _eq(off, exp[0])
    _eq(half, exp[1])


def _refine_check(dev, orig, refp, gidx, depth, **kw):
    """One refine_tables launch against its plain version."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    o, rp = torch.from_numpy(orig).to(dev), torch.from_numpy(refp).to(dev)
    g = torch.from_numpy(gidx.astype(np.int32)).to(dev)
    before = runtime.launches["refine_tables"]
    off, half = me_ssd.refine_tables(o, rp, g, depth=depth, **kw)
    assert runtime.launches["refine_tables"] == before + 1
    exp = me_ssd._refine_direct_plain(
        o, me_ssd._build_phases_plain(rp, depth), g, **kw)
    _eq(off, exp[0])
    _eq(half, exp[1])


@pytest.mark.parametrize("depth", [8, 12, 13, 14])
@pytest.mark.parametrize("size", [16, 32])
@pytest.mark.parametrize("r", [64, 78])
def test_refine_tables_extreme_samples(dev, size, r, depth):
    """A checkerboard of 0 and 2^depth - 1 in 4-sample cells, displaced in
    the reference so that the positive taps meet the maximum (the
    horizontal intermediate at its extremes, about 88 * 16383 >> 4 at 14
    bits), at MVs on the window's corners and edges; r = 78 runs WIDE."""
    from hevc_tpu_torch.ops import me_ssd
    h, w = 96, 160
    top = (1 << depth) - 1
    yy, xx = np.mgrid[0:h + 16, 0:w + 16]
    t = (((yy >> 2) + (xx >> 2)) & 1) * top
    dt = me_ssd.me_dtype(depth)
    orig = t[8:8 + h, 8:8 + w].astype(dt)
    refp = np.pad(t[5:5 + h, 6:6 + w], PAD, mode="edge").astype(dt)
    ny, nx, nyx = h // size, w // size, 2 * r + 1
    ends = [(dy + r) * nyx + dx + r for dy in (-r, 0, r) for dx in (-r, 0, r)]
    gidx = np.array([ends[b % 9] for b in range(ny * nx)])
    _refine_check(dev, orig, refp, gidx, depth, size=size, r=r, ny=ny,
                  nx=nx, pad=PAD)


@pytest.mark.parametrize("size,depth", [(32, 8), (16, 8), (32, 10),
                                        (16, 10)])
def test_refine_tables_many_blocks(dev, size, depth):
    """A 2160x3840 grid: far more search blocks (8100 of 32x32, 32400 of
    16x16) than the card holds at once."""
    h, w = 2160, 3840
    orig, refp = _refine_planes(h, w, depth, seed=size + depth)
    ny, nx, r = h // size, w // size, 16
    rng = np.random.default_rng(size)
    gidx = rng.integers(0, (2 * r + 1) ** 2, ny * nx)
    _refine_check(dev, orig, refp, gidx, depth, size=size, r=r, ny=ny,
                  nx=nx, pad=PAD)


@pytest.mark.parametrize("depth", [8, 10, 12, 14])
@pytest.mark.parametrize("count", [1, 2, 4, 8])
def test_wp_apply_multi_matches_plain(dev, count, depth):
    """One launch over `count` planes against the plain version: padded
    1080p planes, an odd-sized plane (the one-by-one tail), views that
    start at an odd offset (the unaligned path) and identity triples."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.ops import me_ssd
    rng = np.random.default_rng(count * 16 + depth)
    dt = me_ssd.me_dtype(depth)
    shapes = [(1240, 2080), (37, 53), (64, 96), (1240, 2080), (31, 17),
              (64, 96), (8, 8), (1240, 2080)][:count]
    planes = []
    for k, (h, w) in enumerate(shapes):
        big = torch.from_numpy(rng.integers(0, 1 << depth, h * w + 1).astype(
            dt)).to(dev)
        planes.append((big[1:] if k % 3 == 2 else big[:-1]).view(h, w))
    triples = [(45, 12, 6), (1, 0, 0), (-20, 7, 3), (255, 127, 7),
               (1, 0, 0), (0, 9, 2), (-128, -128, 7), (7, -3, 0)][:count]
    before = runtime.launches["wp_apply"]
    got = me_ssd.wp_apply_multi(planes, triples, depth)
    assert runtime.launches["wp_apply"] == before + 1
    exp = me_ssd.wp_apply_multi_plain(planes, triples, depth)
    assert len(got) == count
    for g, e, p in zip(got, exp, planes):
        assert g.dtype == p.dtype and g.shape == p.shape
        _eq(g, e)


def test_wp_apply_multi_rejects_too_many_planes(dev):
    from hevc_tpu_torch.ops import me_ssd
    planes = [torch.zeros((16, 16), dtype=torch.uint8, device=dev)] * 9
    with pytest.raises(ValueError):
        me_ssd.wp_apply_multi(planes, [(1, 0, 0)] * 9, 8)


def test_refine_and_wp_reject_bad_arguments(dev):
    from hevc_tpu_torch.ops import me_ssd
    plane = torch.zeros((120, 140), dtype=torch.int32, device=dev)
    g = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(NotImplementedError):
        me_ssd.refine_tables(plane, plane, g, size=16, r=4, ny=2, nx=2,
                             pad=PAD, depth=16)
    with pytest.raises(NotImplementedError):
        me_ssd.wp_apply(plane, (1, 0, 0), 16)
    u8 = torch.zeros((200, 200), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        me_ssd.refine_tables(u8, u8, g, size=8, r=4, ny=2, nx=2, pad=PAD,
                             depth=8)
    with pytest.raises(ValueError):
        me_ssd.wp_apply(u8, (1, 0, 0), 10)   # a 10-bit plane is int16


@pytest.mark.parametrize("refine,wp", [("1", False), ("0", True)])
def test_refine_and_wp_encode_on_card_matches_cpu(dev, monkeypatch, refine,
                                                  wp):
    """An LDP encode with the refine tables (the default prefilter), and a
    fade with WeightedPredP=1: identical bytes on the card and the CPU,
    and the card ran the kernel."""
    from hevc_tpu_torch import runtime
    from hevc_tpu_torch.encoder.top import EncoderTop
    from hevc_tpu_torch.io.cfg import EncoderConfig, parse_cfg_file
    monkeypatch.setenv("HEVC_TPU_ME_REFINE", refine)
    frames = moving_frames(6, 128, 80, seed=4)
    if wp:
        frames = [[(p * (1.0 - 0.1 * t)).astype(np.uint8) if i == 0 else p
                   for i, p in enumerate(f)] for t, f in enumerate(frames)]

    def run(device):
        cfg = parse_cfg_file(LDP_CFG, EncoderConfig())
        cfg.width, cfg.height, cfg.frames_to_encode = 128, 80, 6
        cfg.weighted_pred_p = int(wp)
        enc = EncoderTop(cfg, device=device)
        return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    key = "wp_apply" if wp else "refine_tables"
    before = runtime.launches[key]
    got = run("cuda")
    assert runtime.launches[key] > before
    assert got == run("cpu")
