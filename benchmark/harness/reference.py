"""The plain reference that decides `correct`: NumPy and PyTorch only.

It imports nothing of the encoder under test. What it needs of the HEVC
syntax (Annex-B framing, the decoded-picture-hash SEI) it parses itself;
the motion search and the intra prescreen it computes again from the
pictures the benchmark made, in exact integer arithmetic (float64 products
of integers below 2^53). The search's and the prescreen's algorithms (the
two-pass argmin with its 3x3 regional pass, the 35-mode prescreen with
its mode-cost table and top-k order) are frozen copies of the encoder's
design, written anew here, so a later change to the encoder cannot move
them. The stream is decoded by the benchmark's own decoder (`decode.py`).

Three layers are compared here:
  stream   every picture's bytes carry a decoded-picture-hash SEI whose
           MD5 equals the MD5 of that picture's reconstruction, for every
           picture coded in the window;
  search   the integer motion vectors of both grids of sampled searches;
  screen   the candidate mode lists and best costs of the prescreen.

The search and the prescreen can be computed at a lower sample precision
(`drop_bits`): the control, which puts this reference in the program's
place with the samples' `drop_bits` low bits cleared.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

# ----------------------------------------------------------------- stream
SUFFIX_SEI = 40
HASH_PAYLOAD = 132


def split_nals(data: bytes) -> list:
    """Annex-B byte stream -> [(NAL unit without its start code, bytes it
    takes in the stream)]: a unit takes its start code (with a leading
    zero_byte) and any trailing zeros, so the sizes add up to len(data)."""
    starts = []
    i = data.find(b"\x00\x00\x01")
    while i >= 0:
        starts.append(i)
        i = data.find(b"\x00\x00\x01", i + 3)
    begins = [p - 1 if p > 0 and data[p - 1] == 0 else p for p in starts]
    if begins:
        begins[0] = 0
    out = []
    for k, p in enumerate(starts):
        end = begins[k + 1] if k + 1 < len(starts) else len(data)
        body = data[p + 3:end].rstrip(b"\x00")
        out.append((body, end - begins[k]))
    return out


def unescape(nal: bytes) -> bytes:
    """Remove emulation-prevention bytes (00 00 03 -> 00 00)."""
    out = bytearray()
    zeros = 0
    for b in nal:
        if zeros >= 2 and b == 3:
            zeros = 0
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def hash_digests(nal: bytes):
    """The per-plane MD5 digests of a decoded-picture-hash SEI NAL unit,
    or None when the NAL unit carries no MD5 picture hash."""
    rbsp = unescape(nal[2:])
    i = 0
    while i < len(rbsp) and rbsp[i] != 0x80:
        ptype = 0
        while rbsp[i] == 0xFF:
            ptype += 255
            i += 1
        ptype += rbsp[i]
        i += 1
        size = 0
        while rbsp[i] == 0xFF:
            size += 255
            i += 1
        size += rbsp[i]
        i += 1
        payload = rbsp[i:i + size]
        i += size
        if ptype == HASH_PAYLOAD and payload and payload[0] == 0:
            body = payload[1:]
            return [bytes(body[k:k + 16]) for k in range(0, len(body), 16)]
    return None


def access_units(data: bytes) -> list:
    """[(bytes in the stream, digests or None, first-slice count)] of the
    pictures in an Annex-B byte stream, in decoding order: a picture's
    unit runs from the first NAL unit after the previous picture's hash
    SEI through its own hash SEI."""
    units = []
    size = 0
    firsts = 0
    for nal, nbytes in split_nals(data):
        ntype = (nal[0] >> 1) & 0x3F
        size += nbytes
        if ntype < 32 and len(nal) > 2 and nal[2] & 0x80:
            firsts += 1
        if ntype == SUFFIX_SEI:
            d = hash_digests(nal)
            if d is not None:
                units.append((size, d, firsts))
                size = 0
                firsts = 0
    if size:
        units.append((size, None, firsts))
    return units


def quantize(plane: np.ndarray, drop_bits: int) -> np.ndarray:
    """The plane with its `drop_bits` low bits cleared (drop_bits 0: as
    is)."""
    if not drop_bits:
        return plane
    return (plane.astype(np.int32) >> drop_bits << drop_bits).astype(
        plane.dtype)


def picture_md5(planes, bit_depth: int) -> tuple:
    """MD5 of each plane as the hash SEI defines it: one byte a sample at
    8 bits, two (little-endian) above."""
    out = []
    for p in planes:
        p = np.asarray(p)
        dt = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
        out.append(hashlib.md5(np.ascontiguousarray(p.astype(dt)))
                   .digest())
    return tuple(out)


def psnr_y(src: np.ndarray, rec: np.ndarray, bit_depth: int) -> float:
    """Luma PSNR in dB (99.99 for a lossless picture, as HM prints it)."""
    d = src.astype(np.int64) - rec.astype(np.int64)
    mse = float((d * d).sum()) / d.size
    peak = (1 << bit_depth) - 1
    return 99.99 if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def check_stream(data: bytes, recons: dict, bit_depth: int):
    """Match every picture unit of `data` to a reconstruction by its hash.

    recons: {display index: [Y, Cb, Cr]} of the pictures coded in `data`.
    Returns (mismatches, bits by display index): a mismatch is a coded
    picture whose unit lacks a hash, whose hash matches no reconstruction,
    or a second one, or a reconstruction no unit matched."""
    by_hash = {picture_md5(pl, bit_depth): idx
               for idx, pl in recons.items()}
    bits = {}
    bad = 0
    for size, digests, firsts in access_units(data):
        idx = by_hash.get(tuple(digests)) if digests else None
        if idx is None or idx in bits or firsts != 1:
            bad += 1
            continue
        bits[idx] = size * 8
    bad += sum(1 for idx in recons if idx not in bits)
    return bad, bits


# ----------------------------------------------------------------- search
def mv_bits(v: torch.Tensor) -> torch.Tensor:
    """Signed Exp-Golomb length of a quarter-sample MV component (HM's
    xGetComponentBits): 2 * floor(log2(t)) + 1, t = 2|v| + (v <= 0)."""
    t = torch.where(v <= 0, (-v) * 2 + 1, v * 2).to(torch.float64)
    return (2 * torch.floor(torch.log2(t) + 1e-9) + 1).to(torch.int64)


def lam_q8(lam_fp: int, depth: int) -> int:
    """The search's lambda in Q8 from the fixed-point sqrt-lambda, scaled
    to the depth of the SSD (samples above 10 bits are searched at 10)."""
    s = lam_fp / 65536.0
    q = max(1, int(round(s * s * 256.0)))
    return q << (2 * (min(depth, 10) - 8) if depth > 8 else 0)


def grid_dims(h: int, w: int, size: int):
    return ((h - size) // size + 1 if h >= size else 0,
            (w - size) // size + 1 if w >= size else 0)


def ssd_table(roi: torch.Tensor, orig: torch.Tensor, size: int, r: int,
              ny: int, nx: int) -> torch.Tensor:
    """SSD[n, dy, dx] (int64) of every aligned size x size block n of
    `orig` against `roi` at each integer offset: sum a^2 over the window,
    plus sum b^2, minus twice the correlation, each exact."""
    aw = 2 * r + size
    nyx = 2 * r + 1
    n = ny * nx
    dev = roi.device
    a = roi.to(torch.float64)
    areas = a.unfold(0, aw, size).unfold(1, aw, size)[:ny, :nx].reshape(
        n, aw, aw)
    blks = orig[:ny * size, :nx * size].to(torch.float64).reshape(
        ny, size, nx, size).permute(0, 2, 1, 3).reshape(n, size, size)
    # corr[n, dy, dx] = sum_i areas[n, dy + i, :] . toeplitz_i[:, dx]
    j = (torch.arange(aw, device=dev)[:, None]
         - torch.arange(nyx, device=dev)[None, :])
    valid = ((j >= 0) & (j < size)).to(torch.float64)
    jc = j.clamp(0, size - 1).reshape(-1)
    corr = torch.zeros((n, nyx, nyx), dtype=torch.float64, device=dev)
    for i in range(size):
        t = blks[:, i, :].index_select(1, jc).reshape(n, aw, nyx) * valid
        corr += torch.bmm(areas[:, i:i + nyx, :], t)
    sq = roi.to(torch.int64) ** 2
    ii = torch.nn.functional.pad(sq.cumsum(0).cumsum(1), (1, 0, 1, 0))
    box = (ii[size:, size:] - ii[:-size, size:] - ii[size:, :-size]
           + ii[:-size, :-size])
    rows = (torch.arange(ny, device=dev)[:, None] * size
            + torch.arange(nyx, device=dev)[None, :]).reshape(-1)
    cols = (torch.arange(nx, device=dev)[:, None] * size
            + torch.arange(nyx, device=dev)[None, :]).reshape(-1)
    win = (box.index_select(0, rows).index_select(1, cols)
           .reshape(ny, nyx, nx, nyx).permute(0, 2, 1, 3)
           .reshape(n, nyx, nyx))
    b2 = (blks * blks).sum(dim=(1, 2)).to(torch.int64)
    return win + b2[:, None, None] - 2 * torch.round(corr).to(torch.int64)


LOCAL_W = 8


def argmin_two_pass(ssd: torch.Tensor, lam: int, r: int, ny: int,
                    nx: int) -> torch.Tensor:
    """Flat (dy, dx) index of each block's MV: pass 1 takes the argmin of
    the cost (SSD + lambda * zero-predictor MV bits >> 8) summed over the
    block's 3x3 neighbourhood; pass 2 the argmin of the cost with the rate
    centred on that MV, within +-8 of it, unless the block's global
    minimum of that cost is cheaper by more than an eighth. First minimum
    in row-major order everywhere."""
    nyx = 2 * r + 1
    n = ny * nx
    dev = ssd.device
    d = torch.arange(nyx, dtype=torch.int64, device=dev) - r
    bits0 = mv_bits(d * 4)[:, None] + mv_bits(d * 4)[None, :]
    cost1 = (ssd + ((lam * bits0) >> 8)).reshape(ny, nx, nyx * nyx)
    cp = torch.nn.functional.pad(cost1, (0, 0, 1, 1, 1, 1))
    sm = sum(cp[dy:dy + ny, dx:dx + nx] for dy in range(3)
             for dx in range(3))
    idxr = torch.argmin(sm.reshape(n, -1), dim=1)
    py, px = idxr // nyx - r, idxr % nyx - r
    bits2 = (mv_bits(d[None, :, None] * 4 - py[:, None, None] * 4)
             + mv_bits(d[None, None, :] * 4 - px[:, None, None] * 4))
    cost2 = (ssd + ((lam * bits2) >> 8)).reshape(n, -1)
    local = (((d[None, :, None] - py[:, None, None]).abs() <= LOCAL_W)
             & ((d[None, None, :] - px[:, None, None]).abs() <= LOCAL_W))
    masked = torch.where(local.reshape(n, -1), cost2,
                         torch.full_like(cost2, 1 << 30))
    i_loc = torch.argmin(masked, dim=1)
    c_loc = torch.gather(masked, 1, i_loc[:, None])[:, 0]
    i_g = torch.argmin(cost2, dim=1)
    c_g = torch.gather(cost2, 1, i_g[:, None])[:, 0]
    return torch.where(c_g + (c_loc >> 3) < c_loc, i_g, i_loc)


def pad_edge(plane: np.ndarray, pad: int) -> np.ndarray:
    return np.pad(plane, pad, mode="edge")


def search_grids(orig: np.ndarray, ref_padded: np.ndarray, *, size: int,
                 size2: int, r: int, lam_fp: int, pad: int, depth: int,
                 device, drop_bits: int = 0) -> tuple:
    """(gx, gy, gx2, gy2) int64 grids of one reference: the CU-grid size
    at +-r and its half at +-min(r, 16). Samples above 10 bits are
    searched at 10 (shifted right)."""
    shift = max(0, depth - 10)
    o = torch.from_numpy(quantize(orig, drop_bits).astype(np.int64)).to(
        device) >> shift
    rp = torch.from_numpy(quantize(ref_padded, drop_bits).astype(
        np.int64)).to(device) >> shift
    lam = lam_q8(lam_fp, depth)
    h, w = orig.shape
    out = []
    for sz, rr in ((size, r), (size2, min(r, 16))):
        ny, nx = grid_dims(h, w, sz)
        aw = 2 * rr + sz
        roi = rp[pad - rr:pad - rr + (ny - 1) * sz + aw,
                 pad - rr:pad - rr + (nx - 1) * sz + aw]
        idx = argmin_two_pass(ssd_table(roi, o, sz, rr, ny, nx), lam, rr,
                              ny, nx).cpu().numpy()
        nyx = 2 * rr + 1
        out += [(idx % nyx - rr).reshape(ny, nx),
                (idx // nyx - rr).reshape(ny, nx)]
    return tuple(out)


# ----------------------------------------------------------------- screen
# intraPredAngle of modes 2..34 (HEVC Table 8-5)
ANGLE = [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
         -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32]
# intraHorVerDistThres by block size (8.4.4.2.3)
DIST_THRESH = {8: 7, 16: 1, 32: 0}
# candidates kept a block, by block size (HM's g_aucIntraModeNumFast);
# 4x4 blocks give costs only
K_OF_SIZE = {4: 0, 8: 8, 16: 3, 32: 3}


def _filtered(mode: int, n: int) -> bool:
    if n == 4 or mode == 1:
        return False
    dist = min(abs(mode - 26), abs(mode - 10)) if mode >= 2 else 10
    return dist > DIST_THRESH[n]


def predict_all(left: torch.Tensor, top: torch.Tensor, corner: torch.Tensor,
                n: int, bit_depth: int) -> torch.Tensor:
    """All 35 luma intra predictions [B, 35, n, n] (row y, column x) from
    the 2n left samples p[-1][y], the 2n top samples p[x][-1] and the
    corner, each [B, ...] int64, as HEVC 8.4.4.2 defines them, with the
    [1 2 1] reference smoothing where 8.4.4.2.3 asks for it (no strong
    smoothing). Modes are 0 planar, 1 DC, 2..34 angular."""
    b = left.shape[0]
    dev = left.device
    # the reference line from p[-1][2n-1] up to the corner and along to
    # p[2n-1][-1], smoothed with its two ends kept
    line = torch.cat([left.flip(1), corner[:, None], top], dim=1)
    sm = line.clone()
    sm[:, 1:-1] = (line[:, :-2] + 2 * line[:, 1:-1] + line[:, 2:] + 2) >> 2
    maxval = (1 << bit_depth) - 1
    log2n = n.bit_length() - 1
    ys = torch.arange(n, device=dev)
    preds = torch.empty((b, 35, n, n), dtype=torch.int64, device=dev)
    for mode in range(35):
        ln = sm if _filtered(mode, n) else line
        lf = ln[:, :2 * n].flip(1)          # p[-1][0 .. 2n-1]
        cn = ln[:, 2 * n]
        tp = ln[:, 2 * n + 1:]              # p[0 .. 2n-1][-1]
        if mode == 0:
            p = (((n - 1 - ys)[None, None, :] * lf[:, :n, None]
                  + (ys + 1)[None, None, :] * tp[:, n, None, None]
                  + (n - 1 - ys)[None, :, None] * tp[:, None, :n]
                  + (ys + 1)[None, :, None] * lf[:, n, None, None]
                  + n) >> (log2n + 1))
        elif mode == 1:
            dc = (tp[:, :n].sum(1) + lf[:, :n].sum(1) + n) >> (log2n + 1)
            p = dc[:, None, None].expand(b, n, n).clone()
            if n < 32:
                p[:, 0, 1:] = (tp[:, 1:n] + 3 * dc[:, None] + 2) >> 2
                p[:, 1:, 0] = (lf[:, 1:n] + 3 * dc[:, None] + 2) >> 2
                p[:, 0, 0] = (lf[:, 0] + 2 * dc + tp[:, 0] + 2) >> 2
        else:
            ang = ANGLE[mode - 2]
            vertical = mode >= 18
            main = tp if vertical else lf       # main side, index 0 = p0
            side = lf if vertical else tp
            # ref[k] for k = -n .. 2n: ref[0] = corner, ref[k > 0] =
            # main[k - 1], ref[k < 0] projected from the side samples
            ref = torch.zeros((b, 3 * n + 1), dtype=torch.int64, device=dev)
            ref[:, n] = cn
            ref[:, n + 1:] = main
            if ang < 0 and (n * ang) >> 5 < -1:
                inv = int(round(8192.0 / ang))
                for k in range((n * ang) >> 5, 0):
                    s = -1 + ((k * inv + 128) >> 8)
                    ref[:, n + k] = cn if s < 0 else side[:, s]
            rows = []
            for i in range(n):                  # distance from the main side
                idx = ((i + 1) * ang) >> 5
                fact = ((i + 1) * ang) & 31
                k = ys + idx + 1 + n
                a = ref.index_select(1, k)
                c = ref.index_select(1, (k + 1).clamp(max=3 * n))
                rows.append(((32 - fact) * a + fact * c + 16) >> 5)
            p = torch.stack(rows, dim=1)        # [B, i, j]
            if not vertical:
                p = p.transpose(1, 2)
            if mode == 26 and n < 32:
                p[:, :, 0] = (tp[:, 0:1] + ((lf[:, :n] - cn[:, None]) >> 1)
                              ).clamp(0, maxval)
            if mode == 10 and n < 32:
                p[:, 0, :] = (lf[:, 0:1] + ((tp[:, :n] - cn[:, None]) >> 1)
                              ).clamp(0, maxval)
        preds[:, mode] = p
    return preds


def _hadamard(t: int, device) -> torch.Tensor:
    h = torch.ones((1, 1), dtype=torch.float64, device=device)
    while h.shape[0] < t:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h


def satd(d: torch.Tensor, n: int) -> torch.Tensor:
    """HM's Hadamard SATD of difference blocks [..., n, n]: 8x8 tiles for
    n >= 8, (sum |H d H| + 2) >> 2 each; 4x4 tiles (+1 >> 1) for n = 4."""
    t = 8 if n >= 8 else 4
    h = _hadamard(t, d.device)
    lead = d.shape[:-2]
    x = d.to(torch.float64).reshape(lead + (n // t, t, n // t, t))
    x = x.movedim(-3, -2)
    m = torch.round(h @ x @ h).to(torch.int64).abs().sum(dim=(-1, -2))
    m = (m + (2 if t == 8 else 1)) >> (2 if t == 8 else 1)
    return m.sum(dim=(-1, -2))


def mode_cost_table(sqrt_lam: float) -> list:
    """sqrt(lambda) times the estimated mode bits: planar 2, DC and
    vertical 3, every other mode 6."""
    bits = [2, 3] + [3 if m == 26 else 6 for m in range(2, 35)]
    return [round(sqrt_lam * b) for b in bits]


def screen(orig: np.ndarray, bit_depth: int, sqrt_lam: float, device,
           log2s=(2, 3, 4, 5), drop_bits: int = 0, chunk: int = 8192):
    """{log2: (cands uint8 [ny, nx, k], costs int64 [ny, nx])}: for every
    aligned block, the k cheapest modes by SATD of the prediction from
    the ORIGINAL neighbouring samples plus the mode cost (ties: lower mode
    first), and the cheapest cost. Neighbours outside the picture take
    the mid level; those past the right or bottom edge repeat the last
    column or row."""
    h, w = orig.shape
    mid = 1 << (bit_depth - 1)
    o = quantize(orig, drop_bits).astype(np.int64)
    pl = np.full((h + 1, w + 1), mid, np.int64)
    pl[1:, 1:] = o
    plane = torch.from_numpy(pl).to(device)
    lam = torch.tensor(mode_cost_table(sqrt_lam), dtype=torch.int64,
                       device=device)
    modes = torch.arange(35, dtype=torch.int64, device=device)
    out = {}
    for log2 in log2s:
        n = 1 << log2
        ny, nx = h // n, w // n
        if not (ny and nx):
            continue
        k = K_OF_SIZE[n]
        y0 = (torch.arange(ny, device=device)[:, None] * n).expand(
            ny, nx).reshape(-1)
        x0 = (torch.arange(nx, device=device)[None, :] * n).expand(
            ny, nx).reshape(-1)
        s2 = torch.arange(2 * n, device=device)
        ii = torch.arange(n, device=device)
        cands, costs = [], []
        for s in range(0, ny * nx, chunk):
            by, bx = y0[s:s + chunk], x0[s:s + chunk]
            top = plane[by[:, None], (bx[:, None] + 1 + s2).clamp(max=w)]
            left = plane[(by[:, None] + 1 + s2).clamp(max=h), bx[:, None]]
            corner = plane[by, bx]
            blk = plane[by[:, None, None] + 1 + ii[None, :, None],
                        bx[:, None, None] + 1 + ii[None, None, :]]
            pr = predict_all(left, top, corner, n, bit_depth)
            cost = satd(pr - blk[:, None], n) + lam[None, :]
            costs.append(cost.min(dim=1).values)
            if k:
                key = cost * 64 + modes[None, :]
                cands.append(torch.sort(key, dim=1).values[:, :k] & 63)
        c = torch.cat(costs).reshape(ny, nx).cpu().numpy()
        if k:
            cd = torch.cat(cands).reshape(ny, nx, k).cpu().numpy().astype(
                np.uint8)
        else:
            cd = np.zeros((ny, nx, 0), np.uint8)
        out[log2] = (cd, c)
    return out
