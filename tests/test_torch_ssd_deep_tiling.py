"""A CPU model of the deep SSD kernel's decomposition (ssd_table_deep in
hevc_tpu_torch/csrc/me_ssd.cu), held exactly to hevc_tpu's
me_mxu._ssd_table_deep on JAX-CPU and to the port's plain version.

The model runs the kernel's index arithmetic lane by lane in numpy: the
shared-memory layout (rows, stride, B-word table), the biased hi'/lo'
window bytes and the signed hi/lo/s B words, each lane's ldmatrix row
address and B-word offset, the pairing of 16-byte k segments into
m16n8k32 k-steps across block rows, the live n8 tiles of each item, the
fold 16256 c_hh - 127 c_ll + 128 c_ss with its bias term and the output
masks. Every shared-memory read is checked to lie inside the region the
kernel stages, so an indexing fault shows here before the card sees it.
The r values end in partial 16-row and 8-column tiles."""
import functools

import jax
import numpy as np
import pytest
import torch

from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.ops import me_ssd
from test_torch_helpers import at_depth, moving_frames, no_jax_cache_writes
from test_torch_helpers import one_torch_thread  # noqa: F401

PAD = 80


class Layout:
    """DeepLayout<SIZE>(r) of csrc/me_ssd.cu."""

    def __init__(self, size, r):
        self.h, self.rp, self.nv = me_ssd.DEEP_TILES[size]
        self.segs = self.nv // 2 + self.h - 1
        self.bw = 16 * (self.h - 1) + 28
        self.nyx = 2 * r + 1
        self.aw = 2 * r + size
        self.mt_n = -(-self.nyx // 16)
        self.nv_n = -(-self.nyx // 8)
        self.ng_n = -(-self.nv_n // self.nv)
        self.tail = self.nyx - 16 * (self.mt_n - 1)
        self.packed = self.tail * self.mt_n <= 16 and self.nv_n > 2
        self.rows = self.mt_n * 16 + size - 1
        # the end of the columns an item reads: the last group, a full
        # group, the packed tile
        cols = ((self.ng_n - 1) * 8 * self.nv
                + 16 * self.nseg(self.nv_n - (self.ng_n - 1) * self.nv))
        if self.ng_n > 1:
            cols = max(cols, (self.ng_n - 2) * 8 * self.nv + 16 * self.segs)
        if self.packed:
            cols = max(cols, 16 * (self.mt_n - 1 + self.h))
        self.stride = (cols + 15) & ~15
        if not (self.stride >> 4) & 1:
            self.stride += 16
        self.mt_rows = self.mt_n - self.packed

    def nseg(self, live):
        """k segments an item with `live` n8 tiles reads."""
        return ((live - 1) >> 1) + self.h

    def items(self):
        """(m0, dx0, live n8 tiles, packed) of every work item, in the
        kernel's order: full groups, the last group, the packed tile."""
        out = []
        full = (self.ng_n - 1) * self.mt_rows
        for item in range(self.mt_rows * self.ng_n + self.packed):
            pk = item >= self.mt_rows * self.ng_n
            last = item >= full
            mt = (self.mt_n - 1 if pk else item - full if last
                  else item // (self.ng_n - 1))
            ng = self.ng_n - 1 if pk or last else item - mt * (self.ng_n - 1)
            live = 2 if pk else min(self.nv, self.nv_n - ng * self.nv)
            out.append((16 * mt, 0 if pk else 8 * self.nv * ng, live, pk))
        return out

    def tile_row(self, m0, dx0, pk, m):
        """(offset row, first column) of tile row m; rows of the packed
        tile past tail * mt_n get offset row nyx (never stored)."""
        if not pk:
            return m0 + m, dx0
        q = m // self.mt_n
        return m0 + min(q, self.tail), 16 * (m - q * self.mt_n)


def _stage(roi_blk, orig_blk, lay, size, shift, mid):
    """The kernel's staging of one search block: the biased windows
    (hi' = e >> 7, lo' = e & 127, e = (a >> shift) + 576 - mid; anything
    past aw), the B words [3][size][BW] (word w of a row: taps w - 15 .. w - 12
    of the zero-extended row, hi, lo and s = hi + lo as signed bytes), and
    sum(b^2), sum(b) of the centred block."""
    # bytes past aw are never written: they hold whatever the shared
    # memory held, here random bytes
    rng = np.random.default_rng(lay.rows * lay.stride)
    hw = rng.integers(0, 256, (lay.rows, lay.stride), np.uint8)
    lw = rng.integers(0, 256, (lay.rows, lay.stride), np.uint8)
    e = (roi_blk.astype(np.int64) >> shift) + 576 - mid
    assert e.min() >= 64 and e.max() <= 1087
    hw[:lay.aw, :lay.aw] = e >> 7
    lw[:lay.aw, :lay.aw] = e & 127
    c = (orig_blk.astype(np.int64) >> shift) - mid
    lo = ((c + 64) & 127) - 64
    hi = (c - lo) >> 7
    parts = np.stack([hi, lo, hi + lo]).astype(np.int8)  # [3, size, size]
    ext = np.zeros((3, size, lay.bw + 3), np.int8)
    ext[:, :, 15:15 + size] = parts
    words = np.stack([ext[:, :, q:q + lay.bw] for q in range(4)], axis=-1)
    return hw, lw, words, int((c * c).sum()), int(c.sum())


def _a_fragment(win, base, lay):
    """The 16 x 32 A tile (u8) of one k-step as ldmatrix builds it:
    base(row, h) is the byte offset that the lane giving tile row `row`
    of k half h's segment passes (lane l gives row (l & 7) +
    ((l >> 3) & 1) * 8)."""
    flat = win.reshape(-1)
    a = np.empty((16, 32), np.int64)
    for h in range(2):
        for lane in range(16):
            row = (lane & 7) + ((lane >> 3) & 1) * 8
            off = base(row, h)
            assert 0 <= off and off + 16 <= flat.size, "A read outside"
            a[row, 16 * h:16 * h + 16] = flat[off:off + 16]
    return a


def _add_registers(ah, al):
    """s' = hi' + lo' as the kernel forms it: one 32-bit add per register
    of four bytes (consecutive columns, the lowest first), carries and all;
    a byte past aw may carry into the next, which lies past aw too."""
    sh = np.array([0, 8, 16, 24])
    wa = (ah.reshape(16, 8, 4) << sh).sum(-1)
    wl = (al.reshape(16, 8, 4) << sh).sum(-1)
    s = (wa + wl) % (1 << 32)
    return ((s[..., None] >> sh) & 255).reshape(16, 32)


def _b_fragment(words, part, rows, ks, par, lay):
    """The 32 x 8 B tile (s8) of one k-step as the lanes load it: lane
    (g, t) reads, for k half h, the word 16 k_h - 8 par + 4 t - g + 15 of
    block row rows[h]; its bytes are B[16 h + 4 t + q, g]."""
    b = np.empty((32, 8), np.int64)
    for h in range(2):
        for g in range(8):
            for t in range(4):
                w = 16 * ks[h] - 8 * par + 4 * t - g + 15
                assert 0 <= w < lay.bw, "B word outside its row"
                b[16 * h + 4 * t:16 * h + 4 * t + 4, g] = \
                    words[part, rows[h], w]
    return b


def model_ssd_table_deep(roi, orig, *, size, r, ny, nx, depth):
    """The deep SSD tables [ny*nx, nyx, nyx] int32, as the kernel forms
    them (its box plane from the port's plain integral image)."""
    lay = Layout(size, r)
    shift, mid = me_ssd.deep_centring(depth)
    nyx = lay.nyx
    rc = (roi.astype(np.int64) >> shift) - mid
    box = me_ssd._box_energies(torch.from_numpy(rc * rc), size).numpy()
    out = np.zeros((ny * nx, nyx, nyx), np.int64)
    kp_n = lay.rp * lay.h // 2
    for n in range(ny * nx):
        by, bx = divmod(n, nx)
        hw, lw, words, b2, bs = _stage(
            roi[by * size:by * size + lay.aw, bx * size:bx * size + lay.aw],
            orig[by * size:(by + 1) * size, bx * size:(bx + 1) * size], lay,
            size, shift, mid)
        for m0, dx0, live, pk in lay.items():
            rows = [lay.tile_row(m0, dx0, pk, m) for m in range(16)]
            acc = np.zeros((live, 3, 16, 8), np.int64)
            for i in range(0, size, lay.rp):
                for rr in range(lay.rp):
                    for v in range(live):
                        par, u0 = v & 1, v >> 1
                        for kp in range(kp_n):
                            r0, k0 = divmod(2 * kp, lay.h)
                            r1, k1 = divmod(2 * kp + 1, lay.h)
                            if r1 != rr:
                                continue
                            assert u0 + max(k0, k1) < lay.nseg(live)
                            seg = ((r0, k0), (r1, k1))

                            def base(row, h):
                                dy, cx = rows[row]
                                rq, kq = seg[h]
                                return ((dy + i + rq) * lay.stride + cx
                                        + 16 * (u0 + kq))
                            ah = _a_fragment(hw, base, lay)
                            al = _a_fragment(lw, base, lay)
                            for p, a in enumerate(
                                    (ah, al, _add_registers(ah, al))):
                                acc[v, p] += a @ _b_fragment(
                                    words, p, (i + r0, i + r1), (k0, k1),
                                    par, lay)
            fold = (16256 * acc[:, 0] - 127 * acc[:, 1] + 128 * acc[:, 2])
            for v in range(live):
                for row in range(16):
                    dy, cx = rows[row]
                    for col in range(8):
                        dx = cx + 8 * v + col
                        if dy < nyx and dx < nyx:
                            out[n, dy, dx] = (
                                box[by * size + dy, bx * size + dx] + b2
                                + 1152 * bs - 2 * fold[v, row, col])
    # the kernel's wrapping uint32 arithmetic, read as int32
    return ((out + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def _case(size, r, ny, nx, depth, seed):
    """orig and roi planes at `depth` bits: moving texture with the
    samples' two extremes written into a corner of each."""
    aw = 2 * r + size
    h, w = (ny - 1) * size + aw, (nx - 1) * size + aw
    f = moving_frames(2, max(w, 16), max(h, 16), seed=seed)
    top = (1 << depth) - 1
    roi = at_depth(f[0][0], depth)[:h, :w].copy()
    orig = at_depth(f[1][0], depth)[:ny * size, :nx * size].copy()
    roi[:2, :3] = top
    roi[-1, -2:] = 0
    orig[0, :2] = 0
    orig[-1, -1] = top
    return roi, orig


@pytest.mark.parametrize("size,r", [(8, 1), (8, 7), (8, 8), (16, 7),
                                    (16, 8), (16, 24), (32, 1), (32, 8),
                                    (32, 24)])
def test_model_matches_jax(size, r):
    """The model equals hevc_tpu's _ssd_table_deep (three int8 grouped
    correlations of the hi/lo split) at 9, 10, 12 and 14 bits."""
    ny, nx = 1, 2
    for depth in (9, 10, 12, 14):
        roi, orig = _case(size, r, ny, nx, depth, seed=size + r + depth)
        with no_jax_cache_writes():
            exp = np.asarray(jax.jit(functools.partial(
                me_mxu._ssd_table_deep, size=size, r=r, ny=ny, nx=nx,
                depth=depth))(roi, orig))
        got = model_ssd_table_deep(roi, orig, size=size, r=r, ny=ny, nx=nx,
                                   depth=depth)
        np.testing.assert_array_equal(got, exp, err_msg=f"{depth} bits")


@pytest.mark.parametrize("size,r,ny,nx", [(16, 16, 2, 2), (32, 3, 2, 3),
                                          (8, 24, 2, 1)])
def test_model_matches_plain_on_grids(size, r, ny, nx):
    """On grids of several blocks (each with its own window and B words)
    the model equals the port's plain version, the kernel's reference on
    the card."""
    roi, orig = _case(size, r, ny, nx, 10, seed=3 * size + r)
    got = model_ssd_table_deep(roi, orig, size=size, r=r, ny=ny, nx=nx,
                               depth=10)
    exp = me_ssd._ssd_table_deep_plain(
        torch.from_numpy(roi), torch.from_numpy(orig), size=size, r=r,
        ny=ny, nx=nx, depth=10).numpy()
    np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("size,r", [(32, 64), (16, 16), (8, 7)])
def test_layout_and_padded_count(size, r):
    """The layout's rows and stride cover every A read of the model's
    items, the stride is an odd multiple of 16 bytes (ldmatrix rows free of
    bank conflicts), and deep_padded_macs counts the multiply-adds that
    the items' k-steps issue."""
    lay = Layout(size, r)
    assert lay.stride % 32 == 16
    steps, outputs = 0, set()
    for m0, dx0, live, pk in lay.items():
        steps += live * size * lay.h // 2
        segs = lay.nseg(live)  # segments loaded
        for m in range(16):
            dy, cx = lay.tile_row(m0, dx0, pk, m)
            assert dy + size - 1 < lay.rows
            assert cx + 16 * segs <= lay.stride
            outputs |= {(dy, cx + dx) for dx in range(8 * live)
                        if dy < lay.nyx and cx + dx < lay.nyx}
    assert len(outputs) == lay.nyx ** 2  # every offset, each stored once
    assert steps * 16 * 8 * 32 == me_ssd.deep_padded_macs(size, r, 1)
