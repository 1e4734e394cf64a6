"""The plain reference against hand-made cases: Annex-B framing and the
picture hash, the SSD table against a direct sum, the two-pass argmin on
a table with one clear minimum, and the intra predictions of flat
neighbours."""
import hashlib

import numpy as np
import torch

from benchmark.harness import reference as ref


def sei_nal(digests):
    body = bytes([132, 1 + 16 * len(digests), 0]) + b"".join(digests)
    return bytes([40 << 1, 1]) + body + b"\x80"


def test_access_units_and_hashes():
    planes = [np.full((4, 4), v, np.int16) for v in (10, 20, 30)]
    dig = ref.picture_md5(planes, 8)
    assert dig[0] == hashlib.md5(bytes([10] * 16)).digest()
    slice_nal = bytes([1 << 1, 1, 0x80, 0x12, 0x00, 0x00, 0x03, 0x01])
    pps = bytes([34 << 1, 1, 0xC0])
    data = (b"\x00\x00\x00\x01" + pps + b"\x00\x00\x01" + slice_nal
            + b"\x00\x00\x01" + sei_nal(list(dig)))
    units = ref.access_units(data)
    assert len(units) == 1
    size, d, firsts = units[0]
    assert size == len(data) and tuple(d) == dig and firsts == 1
    bad, bits = ref.check_stream(data, {7: planes}, 8)
    assert bad == 0 and bits == {7: len(data) * 8}
    other = [p + 1 for p in planes]
    assert ref.check_stream(data, {7: other}, 8)[0] == 2


def test_unescape():
    assert ref.unescape(b"\x00\x00\x03\x01\x00\x00\x03") == \
        b"\x00\x00\x01\x00\x00"


def test_ssd_table_against_a_direct_sum():
    g = torch.Generator().manual_seed(3)
    size, r, ny, nx = 8, 3, 2, 3
    aw = 2 * r + size
    roi = torch.randint(0, 1024, ((ny - 1) * size + aw,
                                  (nx - 1) * size + aw), generator=g)
    orig = torch.randint(0, 1024, (ny * size, nx * size), generator=g)
    got = ref.ssd_table(roi, orig, size, r, ny, nx)
    for by in range(ny):
        for bx in range(nx):
            b = orig[by * size:(by + 1) * size, bx * size:(bx + 1) * size]
            for dy in range(2 * r + 1):
                for dx in range(2 * r + 1):
                    a = roi[by * size + dy:by * size + dy + size,
                            bx * size + dx:bx * size + dx + size]
                    assert got[by * nx + bx, dy, dx] == ((a - b) ** 2).sum()


def test_argmin_finds_a_clear_minimum_and_the_zero_tie():
    r, ny, nx = 4, 2, 2
    nyx = 2 * r + 1
    ssd = torch.full((ny * nx, nyx, nyx), 10 ** 6, dtype=torch.int64)
    ssd[:, r + 2, r - 1] = 0          # every block: MV (dx, dy) = (-1, 2)
    idx = ref.argmin_two_pass(ssd, 256, r, ny, nx)
    assert (idx == (r + 2) * nyx + (r - 1)).all()
    flat = torch.zeros_like(ssd)      # all equal: the zero MV is cheapest
    assert (ref.argmin_two_pass(flat, 256, r, ny, nx) == r * nyx + r).all()


def test_mv_bits():
    v = torch.tensor([0, 1, -1, 2, -2, 4, 7])
    # HM xGetComponentBits: t = 2|v| + (v <= 0), 2 floor(log2 t) + 1
    assert ref.mv_bits(v).tolist() == [1, 3, 3, 5, 5, 7, 7]


def test_flat_neighbours_predict_flat_blocks():
    for n in (4, 8, 16, 32):
        left = torch.full((1, 2 * n), 77, dtype=torch.int64)
        top = torch.full((1, 2 * n), 77, dtype=torch.int64)
        corner = torch.full((1,), 77, dtype=torch.int64)
        p = ref.predict_all(left, top, corner, n, 8)
        assert p.shape == (1, 35, n, n) and (p == 77).all()


def test_vertical_and_horizontal_copy_their_side():
    n = 8
    top = torch.arange(2 * n, dtype=torch.int64)[None] * 3 + 10
    left = torch.arange(2 * n, dtype=torch.int64)[None] * 5 + 20
    corner = torch.tensor([15])
    p = ref.predict_all(left, top, corner, n, 8)
    # mode 26 copies the top row (column 0 gets the boundary filter)
    assert (p[0, 26, :, 1:] == top[0, 1:n]).all()
    # mode 10 copies the left column (row 0 gets the boundary filter)
    assert (p[0, 10, 1:, :] == left[0, 1:n, None]).all()


def test_screen_of_a_flat_picture():
    orig = np.full((32, 48), 100, np.int16)
    out = ref.screen(orig, 8, 4.0, "cpu")
    assert set(out) == {2, 3, 4, 5}
    cands, costs = out[3]
    assert cands.shape == (4, 6, 8) and costs.shape == (4, 6)
