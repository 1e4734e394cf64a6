"""A CPU model of the refine_tables kernel's decomposition
(refine_tables_kernel in hevc_tpu_torch/csrc/me_refine.cu), held exactly
to hevc_tpu's me_mxu._refine_direct on JAX-CPU and to the port's plain
version.

The model runs the kernel's index arithmetic in numpy, every search block
and lane at once: the shared-memory layout of RefineLayout (the window's
two row and column ranges, the column-major H and P caches and their
pitches, the transpose scratch), the window staging, the H pass's row
runs of RL outputs, the P pass's column runs, each lane's tile column
for every half and quarter candidate (the 16-byte loads with their
offset m), the Hadamard through the scratch with the last stage folded,
the per-warp costs and the strict-< replays. Every shared-memory read is
checked to lie inside the search block's words and every value a result
uses to have been written, and every 16-byte access to be aligned, so an
indexing fault shows here before the card sees it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.ops import me_ssd
from test_torch_helpers import no_jax_cache_writes
from test_torch_helpers import one_torch_thread  # noqa: F401

PAD = 80


class Layout:
    """RefineLayout<SIZE, WIDE> of csrc/me_refine.cu."""

    def __init__(self, size, wide):
        self.size, self.wide = size, wide
        self.T = size // 8
        self.LANES = self.T * self.T * 8
        self.WARPS = self.LANES // 32
        self.SPAN = size + 7
        self.R1 = ((self.SPAN + 3) & ~3) + 1 if wide else 1
        self.ROWS = self.R1 + self.SPAN
        self.C1 = self.SPAN if wide else 1
        self.WCOLS = self.C1 + self.SPAN
        self.WP = self.WCOLS | 1
        self.HC1 = size if wide else 1
        self.HCOLS = self.HC1 + size
        self.HP = (self.ROWS + 3) // 8 * 8 + 4
        self.PR1 = size if wide else 1
        self.PROWS = self.PR1 + size
        self.PP = (self.PROWS + 6) // 8 * 8 + 4
        self.RL = 8 if wide else (11 if size == 32 else 17)
        self.TP = 104
        self.SCR = 4 * self.TP
        self.O_H = (self.ROWS * self.WP + 3) & ~3
        self.O_P20 = self.O_H + 3 * self.HCOLS * self.HP
        self.O_P22 = self.O_P20 + size * self.PP
        self.O_SCR = self.O_P22 + self.HCOLS * self.PP
        self.O_QS = self.O_P20
        self.O_RED = self.O_SCR + self.WARPS * self.SCR
        self.WORDS = (self.O_RED + self.WARPS * 17 + 3) & ~3


class Shared:
    """A region of one search block's shared memory per block, in 32-bit
    words: values and a written mask; addresses are [n, ...] integer
    arrays."""

    def __init__(self, n, words):
        self.v = np.zeros((n, words), np.int64)
        self.w = np.zeros((n, words), bool)
        self.words = words

    def _flat(self, idx):
        idx = np.asarray(idx, np.int64)
        idx = np.broadcast_to(idx, (self.v.shape[0],) + idx.shape[1:])
        assert ((idx >= 0) & (idx < self.words)).all(), "read out of range"
        return idx.reshape(idx.shape[0], -1), idx.shape

    def read(self, idx, check=True):
        flat, shape = self._flat(idx)
        if check:
            assert np.take_along_axis(self.w, flat, 1).all(), \
                "a used word was never written"
        return np.take_along_axis(self.v, flat, 1).reshape(shape)

    def write(self, idx, vals):
        flat, shape = self._flat(idx)
        vals = np.broadcast_to(vals, shape).reshape(flat.shape)
        np.put_along_axis(self.v, flat, vals, 1)
        np.put_along_axis(self.w, flat, True, 1)

    def load_col(self, p, m, count):
        """load_col<count>: 16-byte words from p - m, the values at p."""
        p = np.asarray(p, np.int64)
        m = np.asarray(m, np.int64)
        base = p - m
        assert (base % 4 == 0).all(), "unaligned 16-byte load"
        nw = (count + 1 + 3) // 4
        self.read(base[..., None] + np.arange(4 * nw), check=False)
        return self.read(p[..., None] + np.arange(count))


def filt(f, v, i):
    """filt<F>(v, i) on the last axis."""
    x = [v[..., i + k] for k in range(8 if f != 1 else 7)]
    if f == 1:
        return (-x[0] + 4 * x[1] - 10 * x[2] + 58 * x[3] + 17 * x[4]
                - 5 * x[5] + x[6])
    if f == 2:
        return (40 * (x[3] + x[4]) - 11 * (x[2] + x[5]) + 4 * (x[1] + x[6])
                - (x[0] + x[7]))
    return (x[1] - 5 * x[2] + 17 * x[3] + 58 * x[4] - 10 * x[5] + 4 * x[6]
            - x[7])


def _stages(x, hs):
    """In-place butterflies of the 8-point Hadamard on the last axis."""
    x = x.copy()
    for h in hs:
        for k in range(8):
            if not k & h:
                u, v = x[..., k].copy(), x[..., k + h].copy()
                x[..., k], x[..., k + h] = u + v, u - v
    return x


def model_refine(orig, refp, gidx, *, size, r, ny, nx, pad, depth,
                 half_only=False):
    """(off, half) int32 [ny*nx] as the kernel computes them."""
    n = ny * nx
    ref_h, ref_w = refp.shape
    hr = 2 if depth > 12 else 14 - depth
    s1, off_u, maxv = 6 - hr, 1 << (hr - 1), (1 << depth) - 1
    rnd2, sh2 = 1 << (hr + 5), hr + 6
    wide = (pad - r - 4 < 0
            or pad + (ny - 1) * size + r - 3 > ref_h - 7 - size
            or pad + (nx - 1) * size + r - 3 > ref_w - 7 - size)
    L = Layout(size, wide)
    sm = Shared(n, L.WORDS)
    # the window's region, and the P caches' (P22 from pc22)
    win = Shared(n, L.O_H)
    pc = Shared(n, L.O_SCR - L.O_P20)
    pc22 = L.O_P22 - L.O_P20
    b = np.arange(n)
    by, bx = (b // nx) * size, (b % nx) * size
    nyx = 2 * r + 1
    g = gidx.astype(np.int64)
    base_r = pad + by + g // nyx - r - 3
    base_c = pad + bx + g % nyx - r - 3

    def start(s, dim):
        return np.clip(np.where(s < 0, s + dim, s), 0, dim - size)
    tr0, tr1 = start(base_r - 1, ref_h - 7), start(base_r, ref_h - 7)
    tc0, tc1 = start(base_c - 1, ref_w - 7), start(base_c, ref_w - 7)
    col = lambda a: a[:, None, None]  # noqa: E731

    # 1. the window
    wr = np.arange(L.ROWS)[:, None]
    wc = np.arange(L.WCOLS)[None, :]
    live = np.broadcast_to((not wide) | (wr < L.SPAN) | (wr >= L.R1),
                           (n, L.ROWS, L.WCOLS))
    sr = np.where(wr < L.R1, col(tr0) + wr, col(tr1) + wr - L.R1)
    sc = np.where(wc < L.C1, col(tc0) + wc, col(tc1) + wc - L.C1)
    sr, sc = np.broadcast_arrays(sr, sc)
    assert ((sr[live] >= 0) & (sr[live] < ref_h) & (sc[live] >= 0)
            & (sc[live] < ref_w)).all(), "window outside the plane"
    vals = np.where(live, refp[np.clip(sr, 0, ref_h - 1),
                               np.clip(sc, 0, ref_w - 1)].astype(np.int64),
                    0)
    win.write(np.broadcast_to(wr * L.WP + wc, (n, L.ROWS, L.WCOLS)), vals)
    lt = np.arange(L.LANES)
    tile, j = lt >> 3, lt & 7
    ty, tx, tw, warp = tile // L.T, tile % L.T, tile & 3, lt >> 5
    o = orig.astype(np.int64)[by[:, None, None] + 8 * ty[None, :, None]
                              + np.arange(8)[None, None, :],
                              (bx[:, None] + 8 * tx[None, :] + j)[..., None]]

    # 2a. H_1, H_2, H_3: runs of RL outputs of a row
    hs = L.HCOLS * L.HP
    t = np.arange(L.RL + 7)
    for u in range(L.ROWS):
        if wide and L.SPAN <= u < L.R1:
            continue
        for c0 in range(0, L.HCOLS, L.RL):
            wc0 = c0 if c0 < L.HC1 else L.C1 + c0 - L.HC1
            w = win.read(np.full((n, 1), u * L.WP + wc0) + t)
            for i in range(L.RL):
                for f in (1, 2, 3):
                    sm.write(np.full((n, 1), L.O_H + (f - 1) * hs
                                     + (c0 + i) * L.HP + u),
                             (filt(f, w, i) >> s1)[:, None])
    # 2b. P22 of every H column and P20 of the first SIZE: runs of RL rows
    for c in range(L.HCOLS):
        for u0 in range(0, L.PROWS, L.RL):
            srow = u0 if u0 < L.PR1 else L.R1 + u0 - L.PR1
            v = sm.read(np.full((n, 1), L.O_H + hs + c * L.HP + srow) + t)
            for i in range(L.RL):
                assert c * L.PP + u0 + i < L.HCOLS * L.PP
                pc.write(np.full((n, 1), pc22 + c * L.PP + u0 + i),
                         np.clip((rnd2 + filt(2, v, i)) >> sh2, 0,
                                 maxv)[:, None])
            if c < size:
                v = win.read(np.full((n, 1), srow * L.WP + L.C1 + 3 + c)
                             + t * L.WP)
                for i in range(L.RL):
                    assert c * L.PP + u0 + i < pc22
                    pc.write(np.full((n, 1), c * L.PP + u0 + i),
                             np.clip((32 + filt(2, v, i)) >> 6, 0,
                                     maxv)[:, None])

    def quarter(fy, fx, sy, sx):
        """d [n, LANES, 8] of the lanes' tile columns at phase (fy, fx);
        sy, sx [n] (0: integer shift -1, 1: shift 0)."""
        sy, sx = sy[:, None], sx[:, None]
        hcol = np.where(sx, L.HC1, 0) + 8 * tx + j
        rb = np.where(sy, L.R1, 0) + 8 * ty
        i8 = np.arange(8)
        if fy == 0 and fx == 0:
            p = win.read(((L.R1 + 3 + 8 * ty + i8[:, None]) * L.WP + L.C1
                          + 3 + 8 * tx + j).T[None])
        elif fy == 0:
            v = sm.load_col(L.O_H + (fx - 1) * hs + hcol * L.HP + L.R1 + 3
                            + 8 * ty, 0, 8)
            p = np.clip((v + off_u) >> hr, 0, maxv)
        elif fx == 0:
            v = win.read((rb[..., None] + np.arange(15)) * L.WP
                         + (L.C1 + 3 + 8 * tx + j)[None, :, None])
            p = np.stack([np.clip((32 + filt(fy, v, i)) >> 6, 0, maxv)
                          for i in range(8)], -1)
        else:
            v = sm.load_col(L.O_H + (fx - 1) * hs + hcol * L.HP + rb,
                            np.broadcast_to(sy, rb.shape), 15)
            p = np.stack([np.clip((rnd2 + filt(fy, v, i)) >> sh2, 0, maxv)
                          for i in range(8)], -1)
        return o - p

    def cached(off, c, sy):
        sy = np.broadcast_to(np.asarray(sy)[..., None], (n, L.LANES))
        p = pc.load_col(off + c * L.PP + np.where(sy, L.PR1, 0) + 8 * ty,
                        0 if wide else sy, 8)
        return o - p

    def satd(d):
        """The lanes' shares: the folded |coefficient| sums of a row."""
        d = _stages(d, (1, 2, 4))
        t = (L.O_SCR + warp * L.SCR + tw * L.TP)[None, :]
        wa = np.broadcast_to(t + j * 12, (n, L.LANES))
        assert (wa % 4 == 0).all(), "unaligned scratch store"
        sm.write(wa[..., None] + np.arange(8), d)
        e = sm.read((t + j)[..., None] + 12 * np.arange(8))
        e = _stages(e, (1, 2))
        return 2 * np.maximum(np.abs(e[..., :4]), np.abs(e[..., 4:])).sum(-1)

    def warp_tiles(s, red, k):
        """Round each tile (its 8 lanes), sum a warp's 4 tiles, store."""
        s = s.reshape(n, -1, 8).sum(-1)
        c = ((s + 2) >> 2).reshape(n, L.WARPS, 4).sum(-1)
        sm.write(np.full((n, L.WARPS), red) + np.arange(L.WARPS)
                 * (9 if red == L.O_RED else 8) + k, c)

    # 3. the half stage
    ones, zeros = np.ones(n, np.int64), np.zeros(n, np.int64)
    shares = []
    for k in range(9):
        sy = ones if k // 3 else zeros
        sx = ones if k % 3 else zeros
        cc = 8 * tx + j
        if k == 4:
            d = quarter(0, 0, sy, sx)
        elif k in (3, 5):
            d = quarter(0, 2, sy, sx)
        elif k in (1, 7):
            d = cached(0, cc, sy)
        else:
            d = cached(pc22, np.where(sx[:, None], L.HC1, 0) + cc, sy)
        shares.append(satd(d))
    for k, s in enumerate(shares):
        warp_tiles(s, L.O_RED, k)
    hv = sm.read(np.full((n, 1), L.O_RED) + np.arange(L.WARPS * 9))
    hv = hv.reshape(n, L.WARPS, 9).sum(1)
    bc, cy, cx, hmin = hv[:, 4].copy(), zeros.copy(), zeros.copy(), hv.min(1)
    for k in range(9):
        take = (hv[:, k] < bc) & (k != 4)
        bc = np.where(take, hv[:, k], bc)
        cy = np.where(take, (k // 3 - 1) * 2, cy)
        cx = np.where(take, (k % 3 - 1) * 2, cx)
    qby, qbx = cy.copy(), cx.copy()
    if not half_only:
        redq = L.O_RED + L.WARPS * 9
        for k in range(8):
            kk = k if k < 4 else k + 1
            qy, qx = cy + kk // 3 - 1, cx + kk % 3 - 1
            sy, sx = (qy >> 2) + 1, (qx >> 2) + 1
            key = (qy & 3) * 4 + (qx & 3)
            d = np.zeros((n, L.LANES, 8), np.int64)
            for ph in np.unique(key):
                m = key == ph
                d[m] = quarter(ph // 4, ph % 4, sy, sx)[m]
            sm.write(np.full((n, 1), L.O_QS + k * L.LANES) + lt, satd(d))
        for k in range(8):
            warp_tiles(sm.read(np.full((n, 1), L.O_QS + k * L.LANES) + lt),
                       redq, k)
        qv = sm.read(np.full((n, 1), redq) + np.arange(L.WARPS * 8))
        qv = qv.reshape(n, L.WARPS, 8).sum(1)
        for k in range(8):
            kk = k if k < 4 else k + 1
            take = qv[:, k] < bc
            bc = np.where(take, qv[:, k], bc)
            qby = np.where(take, cy + kk // 3 - 1, qby)
            qbx = np.where(take, cx + kk % 3 - 1, qbx)
    return ((qby + 3) * 7 + (qbx + 3)).astype(np.int32), hmin.astype(
        np.int32)


def _case(size, r, depth, seed, h=64, w=96, extreme=False):
    """orig, the padded reference and integer MVs: smooth texture and a
    displaced noisy copy, or (extreme) a checkerboard of 0 and 2^depth - 1
    in 4-sample cells, phase-shifted in the reference, so that the
    positive taps meet the maximum; MVs at random with the window's
    corners and edges (+-r) among them."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    dt = me_ssd.me_dtype(depth)
    if extreme:
        yy, xx = np.mgrid[0:h + 16, 0:w + 16]
        t = (((yy >> 2) + (xx >> 2)) & 1) * top
        orig, ref = t[8:8 + h, 8:8 + w], t[5:5 + h, 6:6 + w]
    else:
        t = rng.random((h + 16, w + 16))
        for axis in (0, 1):
            t = sum(np.roll(t, k, axis) for k in range(-2, 3)) / 5
        t = np.clip((t - t.mean()) * 6 + 0.5, 0, 1) * top
        orig = np.rint(t[8:8 + h, 8:8 + w])
        ref = np.clip(np.rint(t[6:6 + h, 5:5 + w]
                              + rng.integers(-2, 3, (h, w)) * (top >> 8)),
                      0, top)
    refp = np.pad(ref, PAD, mode="edge").astype(dt)
    ny, nx, nyx = h // size, w // size, 2 * r + 1
    ends = [(dy + r) * nyx + dx + r for dy in (-r, 0, r) for dx in (-r, 0, r)]
    gidx = rng.integers(0, nyx * nyx, ny * nx)
    gidx[:min(9, ny * nx)] = ends[:min(9, ny * nx)]
    return orig.astype(dt), refp, gidx.astype(np.int32), ny, nx


@pytest.mark.parametrize("depth", [8, 10, 12, 14])
@pytest.mark.parametrize("r", [8, 16, 64, 78])
def test_model_matches_jax(depth, r):
    """The model against me_mxu._refine_direct on _build_phases, both
    sizes; r = 78 runs the WIDE layout."""
    for size in (32, 16):
        orig, refp, gidx, ny, nx = _case(size, r, depth, seed=size + r + depth)
        kw = dict(size=size, r=r, ny=ny, nx=nx, pad=PAD)
        got = model_refine(orig, refp, gidx, depth=depth, **kw)
        with no_jax_cache_writes():
            exp = me_mxu._refine_direct(
                jnp.asarray(orig), me_mxu._build_phases(jnp.asarray(refp),
                                                        depth),
                jnp.asarray(gidx), **kw)
        np.testing.assert_array_equal(got[0], np.asarray(exp[0]))
        np.testing.assert_array_equal(got[1], np.asarray(exp[1]))


@pytest.mark.parametrize("depth", [8, 12, 13, 14])
@pytest.mark.parametrize("size,r", [(32, 64), (16, 64), (32, 78),
                                    (16, 78)])
def test_model_extreme_samples_match_plain(size, r, depth):
    """A checkerboard of 0 and 2^depth - 1 (the horizontal intermediate at
    its extremes) at MVs including the window's edges: the model and the
    half-stage probe's model equal the port's plain version."""
    orig, refp, gidx, ny, nx = _case(size, r, depth, seed=depth,
                                     extreme=True)
    kw = dict(size=size, r=r, ny=ny, nx=nx, pad=PAD)
    o, rp = torch.from_numpy(orig), torch.from_numpy(refp)
    g = torch.from_numpy(gidx)
    phases = me_ssd._build_phases_plain(rp, depth)
    exp = me_ssd._refine_direct_plain(o, phases, g, **kw)
    got = model_refine(orig, refp, gidx, depth=depth, **kw)
    np.testing.assert_array_equal(got[0], exp[0].numpy())
    np.testing.assert_array_equal(got[1], exp[1].numpy())
    ob, base_r, base_c = me_ssd._refine_setup(o, g, **kw)
    _, cy, cx, hmin = me_ssd._refine_half_plain(ob, phases, base_r, base_c,
                                                size)
    off, half = model_refine(orig, refp, gidx, depth=depth, half_only=True,
                             **kw)
    np.testing.assert_array_equal(off, ((cy + 3) * 7 + cx + 3).numpy())
    np.testing.assert_array_equal(half, hmin.numpy())


@pytest.mark.parametrize("size,wide", [(32, False), (16, False),
                                       (32, True), (16, True)])
def test_layout(size, wide):
    """The layout's alignment and bank rules: 16-byte aligned regions,
    H and P pitches 4 mod 8 (a tile's 8 lanes read 8 distinct 16-byte
    bank groups), odd window pitch, and the dynamic shared memory of a
    thread block inside the card's 227 KB."""
    lay = Layout(size, wide)
    for off in (lay.O_H, lay.O_P20, lay.O_P22, lay.O_SCR, lay.WORDS):
        assert off % 4 == 0
    assert lay.HP % 8 == 4 and lay.PP % 8 == 4 and lay.WP % 2 == 1
    assert lay.HP >= lay.ROWS and lay.PP >= lay.PROWS + 3
    assert lay.ROWS * lay.WP <= lay.O_H
    assert 8 * lay.LANES <= lay.O_SCR - lay.O_QS
    assert {(3 * jj) % 8 for jj in range(8)} == set(range(8))
    sb = 1 if size == 32 else 2
    assert 4 * sb * lay.WORDS <= 227 * 1024
