"""Frame-wide integer motion search (SSD full search) on the device.

Counterpart of hevc_tpu/ops/me_mxu.py. For every aligned block of the
frame and every integer offset within +-r:
  SSD(dy, dx) = sum(a^2) + sum(b^2) - 2 * corr,
with `corr` the correlation of the block (centred on 128) against its own
search window, and the window energies from a plane-level integral image.
A two-pass argmin follows (pass 1: the cost summed over the 3x3 block
neighbourhood with a zero predictor; pass 2: the predictor-centred rate,
a local argmin within +-LOCAL_W of the pass-1 MV against the global one).
This mirrors the reference's predictor-centred MV cost
(TEncSearch::xPatternSearch costs candidates against the AMVP predictor).

The SSD table (its correlation on the int8 tensor cores), the window
energies it reads (a box-sum plane) and the two-pass argmin (one tiled pass
over the tables) are CUDA kernels (csrc/me_ssd.cu); each has its plain
PyTorch version here (the window energies' is a torch integral image),
which the wrappers run only for tensors on the CPU. Deep bit depths (9-14
bits, int16 planes) take the deep SSD table (the reference's
`_ssd_table_deep`: samples shifted to at most 10 bits and centred, the
correlation as three int8 ones) and the deep window energies, both CUDA
kernels too, and the rate term scaled by `_lam_shift`; 15-16-bit samples
travel as int32 planes (`me_dtype`) and take the kernels' int32 instances.

Two options of the search have kernels of their own (csrc/me_refine.cu).
Weighted prediction (`wp_apply_multi`, one launch a picture) transforms
each reference plane with its (w, o, denom) triple into a new plane that
the search then runs on. The fractional-refine tables (`refine_tables`,
HEVC_TPU_ME_REFINE=1) replay the host engine's half- then quarter-pel SATD
refinement around every grid block's integer MV and return the packed
quarter offset and the 3x3 half-pel minimum of each block. Their plain
versions (`wp_apply_plain`, `wp_apply_multi_plain`, `_build_phases_plain`,
`_satd_of_tiles_plain`, `_refine_direct_plain`) are the reference's XLA
programs written in torch.
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import runtime
from .me import mv_bits

LOCAL_W = 8  # pass-2 local window half-width around the predictor


def lam_q8_of(lam_fp: int) -> int:
    """Full-lambda in Q8 from the reference's fixed-point sqrt-lambda
    (floor(65536*sqrt(lambda)), TEncOpenCL::setLambda)."""
    s = lam_fp / 65536.0
    return max(1, int(round(s * s * 256.0)))


def me_dtype(depth: int):
    """Device transport dtype for ME planes: uint8 keeps the 8-bit path
    int8-ready, int16 carries 9..14-bit samples, int32 16-bit samples."""
    return np.uint8 if depth <= 8 else (np.int16 if depth <= 14 else np.int32)


def bits0_table(r: int) -> np.ndarray:
    from .me import mv_bits_np
    d = np.arange(2 * r + 1) - r
    b = np.array([mv_bits_np(int(v) << 2) for v in d], np.int32)
    return b[:, None] + b[None, :]


@functools.lru_cache(maxsize=None)
def _bits0_dev(r: int, device: torch.device) -> torch.Tensor:
    """Zero-predictor MV-bits table on the device, uploaded once per
    process and device (a pure function of the search range)."""
    return runtime.upload(bits0_table(r), device)


def _pad_edge_dev(plane: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge extension by `pad` samples on every side (jnp.pad mode="edge")
    as one replicate pad: it only copies samples, so it is exact for every
    dtype, and a pad wider than the plane repeats its edge as jnp.pad's
    does."""
    return torch.nn.functional.pad(plane[None, None], (pad,) * 4,
                                   mode="replicate")[0, 0]


def pad_ref_device(plane_dev: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-extend an (unpadded) reference plane on the device: the raw
    plane crosses the host link, not the 2.2x larger padded copy."""
    return _pad_edge_dev(plane_dev, pad)


def _box_energies(p2: torch.Tensor, size: int) -> torch.Tensor:
    """box[y, x] = sum of p2 over the size x size window at (y, x), int32.
    The integral image runs in int64 (torch's cumsum of int32 is int64);
    every window sum fits int32, so the final cast is exact — the same
    values as the reference's wrapping int32 integral image."""
    ii = torch.cumsum(torch.cumsum(p2, dim=0, dtype=torch.int64), dim=1)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))
    box = (ii[size:, size:] - ii[:-size, size:]
           - ii[size:, :-size] + ii[:-size, :-size])
    return box.to(torch.int32)


def deep_centring(depth: int):
    """(shift, mid) of the deep search at `depth` bits: samples are shifted
    to at most 10 effective bits and centred, (a >> shift) - mid."""
    shift = max(0, depth - 10)
    return shift, 1 << (depth - shift - 1)


def box_energies(roi: torch.Tensor, size: int, shift: int = 0,
                 mid: int = 128) -> torch.Tensor:
    """Box-sum plane of the centred squares ((roi >> shift) - mid)^2:
    [H - size + 1, W - size + 1] int32. On the card one kernel launch
    (size 8, 16 or 32): a uint8 plane (shift 0, mid 128) takes the 8-bit
    kernel, an int16 plane of 9-14-bit samples (shift <= 4) or an int32 one
    of 15-16-bit samples (shift 5 or 6) the deep one. Its output rows are
    strided to a multiple of 4 int32 for its 16-byte stores; its plain
    version is `_box_energies` of the squares."""
    if roi.device.type == "cpu":
        rc = (roi.to(torch.int32) >> shift) - mid
        return _box_energies(rc * rc, size)
    deep = roi.dtype in (torch.int16, torch.int32)
    name = "box_energies_deep" if deep else "box_energies"
    runtime.require(roi, roi.dtype if deep else torch.uint8, name + " roi",
                    contiguous=False)
    if roi.stride(1) != 1 or min(roi.shape) < size or size not in (8, 16,
                                                                   32):
        raise ValueError(f"{name}: bad roi shape or layout, or a size other "
                         "than 8, 16 and 32")
    if not deep and (shift, mid) != (0, 128):
        raise ValueError("box_energies: a uint8 plane is centred on 128")
    wide = roi.dtype == torch.int32
    shifts = range(5, 7) if wide else range(0, 5)
    if deep and not (shift in shifts and 0 < mid <= 512):
        raise ValueError("box_energies_deep: shift and mid of 9-14-bit "
                         "(int16) or 15-16-bit (int32) samples")
    out_h, out_w = roi.shape[0] - size + 1, roi.shape[1] - size + 1
    box = torch.empty_strided((out_h, out_w), (-(-out_w // 4) * 4, 1),
                              dtype=torch.int32, device=roi.device)
    lib = runtime.kernel_lib("me_ssd")
    if deep:
        rc = (lib.hevc_box_energies_deep32 if wide
              else lib.hevc_box_energies_deep)(
            roi.data_ptr(), roi.stride(0), out_h, out_w, size, shift, mid,
            box.data_ptr(), box.stride(0), runtime.stream_of(roi))
    else:
        rc = lib.hevc_box_energies(roi.data_ptr(), roi.stride(0), out_h,
                                   out_w, size, box.data_ptr(),
                                   box.stride(0), runtime.stream_of(roi))
    runtime.check(lib, rc, name)
    return box


def _window_energies(p2: torch.Tensor, *, size: int, r: int, ny: int,
                     nx: int) -> torch.Tensor:
    """Per-(block, dy, dx) window energies [ny*nx, nyx, nyx] int32."""
    nyx = 2 * r + 1
    box = _box_energies(p2, size)
    dev = p2.device
    rows = (torch.arange(ny, device=dev)[:, None] * size
            + torch.arange(nyx, device=dev)[None, :]).reshape(-1)
    cols = (torch.arange(nx, device=dev)[:, None] * size
            + torch.arange(nyx, device=dev)[None, :]).reshape(-1)
    return (box.index_select(0, rows).index_select(1, cols)
            .reshape(ny, nyx, nx, nyx).permute(0, 2, 1, 3)
            .reshape(ny * nx, nyx, nyx))


def _blocks(orig: torch.Tensor, size: int, ny: int, nx: int) -> torch.Tensor:
    """[ny*nx, size, size] int32 aligned blocks of a plane."""
    return (orig[:ny * size, :nx * size].to(torch.int32)
            .reshape(ny, size, nx, size).permute(0, 2, 1, 3)
            .reshape(ny * nx, size, size))


def _corr_plain(areas: torch.Tensor, blks: torch.Tensor,
                nyx: int) -> torch.Tensor:
    """corr[n, dy, dx] = sum_{i,j} areas[n, dy+i, dx+j] * blks[n, i, j]
    as one batched matrix product per block row i: the window rows
    areas[n, i:i+nyx, :] times the Toeplitz matrix T[x, dx] = blks[n, i,
    x-dx]. float64 holds every partial sum exactly (|corr| < 2^29)."""
    n, size, _ = blks.shape
    aw = areas.shape[1]
    dev = areas.device
    a = areas.to(torch.float64)
    b = blks.to(torch.float64)
    j = (torch.arange(aw, device=dev)[:, None]
         - torch.arange(nyx, device=dev)[None, :])
    valid = ((j >= 0) & (j < size)).to(torch.float64)
    jc = j.clamp(0, size - 1).reshape(-1)
    corr = torch.zeros((n, nyx, nyx), dtype=torch.float64, device=dev)
    for i in range(size):
        t = b[:, i, :].index_select(1, jc).reshape(n, aw, nyx) * valid
        corr += torch.bmm(a[:, i:i + nyx, :], t)
    return corr.to(torch.int32)


def _ssd_table_plain(roi, orig, *, size, r, ny, nx, shift=0, mid=128):
    """Plain version of the SSD-table kernels (same decomposition, the
    correlation as exact float64 matrix products) of the samples centred
    as (a >> shift) - mid."""
    aw = 2 * r + size
    nyx = 2 * r + 1
    n = ny * nx
    b = (_blocks(orig, size, ny, nx) >> shift) - mid
    rc = (roi.to(torch.int32) >> shift) - mid
    areas = rc.unfold(0, aw, size).unfold(1, aw, size).reshape(n, aw, aw)
    corr = _corr_plain(areas, b, nyx)
    win = _window_energies(rc * rc, size=size, r=r, ny=ny, nx=nx)
    b2 = (b * b).sum(dim=(1, 2), dtype=torch.int32)
    return win + b2[:, None, None] - 2 * corr


def _ssd_table(roi, orig, *, size, r, ny, nx):
    """SSD tables [ny*nx, nyx, nyx] int32 (row-major first-minimum layout)
    for the aligned size x size block grid.

    roi:  [(ny-1)*size + aw, (nx-1)*size + aw] uint8 reference window
          plane whose (0, 0) is integer MV (-r, -r) of block (0, 0); may be
          a strided view into the padded reference
    orig: [>= ny*size, >= nx*size] uint8 source plane"""
    if roi.device.type == "cpu":
        return _ssd_table_plain(roi, orig, size=size, r=r, ny=ny, nx=nx)
    aw = 2 * r + size
    nyx = 2 * r + 1
    if size not in (8, 16, 32):
        raise ValueError(f"ssd_table: block size {size} is not 8, 16 or 32 "
                         "(half of an HEVC CTU)")
    runtime.require(roi, torch.uint8, "ssd_table roi", contiguous=False)
    runtime.require(orig, torch.uint8, "ssd_table orig", contiguous=False)
    if (roi.stride(1) != 1 or orig.stride(1) != 1
            or roi.shape[0] < (ny - 1) * size + aw
            or roi.shape[1] < (nx - 1) * size + aw
            or orig.shape[0] < ny * size or orig.shape[1] < nx * size):
        raise ValueError("ssd_table: bad roi/orig shape or layout")
    box = box_energies(roi, size)
    out = torch.empty((ny * nx, nyx, nyx), dtype=torch.int32,
                      device=roi.device)
    lib = runtime.kernel_lib("me_ssd")
    rc_ = lib.hevc_ssd_table(roi.data_ptr(), roi.stride(0), orig.data_ptr(),
                             orig.stride(0), box.data_ptr(), box.stride(0),
                             out.data_ptr(), size, r, ny, nx,
                             runtime.stream_of(roi))
    runtime.check(lib, rc_, "ssd_table")
    return out


def _ssd_table_deep_plain(roi, orig, *, size, r, ny, nx, depth):
    """Plain version of the deep SSD-table kernel: the correlation of the
    centred samples directly (|corr| <= 1024 * 512^2 < 2^29, exact in
    float64), which is what the reference's three int8 correlations of the
    hi/lo split add up to."""
    shift, mid = deep_centring(depth)
    return _ssd_table_plain(roi, orig, size=size, r=r, ny=ny, nx=nx,
                            shift=shift, mid=mid)


# The deep SSD kernel's tiling (csrc/me_ssd.cu DeepTile): block size ->
# (H, RP, NV): the 16-byte k segments of a block row that one n8 tile of
# offsets reads, the block rows of a pass of its k loop, and the n8 tiles
# of a work item.
DEEP_TILES = {32: (3, 2, 4), 16: (2, 1, 6), 8: (2, 1, 6)}


def deep_padded_macs(size: int, r: int, nblocks: int) -> int:
    """Multiply-adds the deep kernel issues for one of its three products
    over nblocks search blocks, padding included: m16 x n8 tiles of
    offsets (16-row tiles of dy by the 8-column tiles that hold a table
    column, the last 16-row tile packed into two n8 tiles where it holds
    few rows), each H k segments of 16 a block row (the unpadded count is
    nblocks * (2r + 1)^2 * size^2)."""
    h = DEEP_TILES[size][0]
    nyx = 2 * r + 1
    mt_n, nv_n = -(-nyx // 16), -(-nyx // 8)
    packed = (nyx - 16 * (mt_n - 1)) * mt_n <= 16 and nv_n > 2
    tiles = (mt_n - 1) * nv_n + 2 if packed else mt_n * nv_n
    return nblocks * tiles * 16 * 8 * size * h * 16


def _ssd_table_deep(roi, orig, *, size, r, ny, nx, depth):
    """SSD tables [ny*nx, nyx, nyx] int32 of deep samples, as _ssd_table's
    layout: roi and orig int16 planes of 9-14-bit samples or int32 planes
    of 15-16-bit ones (roi may be a strided view into the padded
    reference). On the card the deep window energies, then the deep
    SSD-table kernel (its int32 instance for int32 planes)."""
    if roi.device.type == "cpu":
        return _ssd_table_deep_plain(roi, orig, size=size, r=r, ny=ny,
                                     nx=nx, depth=depth)
    aw = 2 * r + size
    nyx = 2 * r + 1
    if size not in (8, 16, 32):
        raise ValueError(f"ssd_table_deep: block size {size} is not 8, 16 "
                         "or 32 (half of an HEVC CTU)")
    if not 8 < depth <= 16:
        raise ValueError(f"ssd_table_deep: {depth}-bit samples (9-14 bits "
                         "travel as int16, 15-16 bits as int32)")
    wide = depth > 14
    dt = torch.int32 if wide else torch.int16
    runtime.require(roi, dt, "ssd_table_deep roi", contiguous=False)
    runtime.require(orig, dt, "ssd_table_deep orig", contiguous=False)
    if (roi.stride(1) != 1 or orig.stride(1) != 1
            or roi.shape[0] < (ny - 1) * size + aw
            or roi.shape[1] < (nx - 1) * size + aw
            or orig.shape[0] < ny * size or orig.shape[1] < nx * size):
        raise ValueError("ssd_table_deep: bad roi/orig shape or layout")
    shift, mid = deep_centring(depth)
    box = box_energies(roi, size, shift, mid)
    out = torch.empty((ny * nx, nyx, nyx), dtype=torch.int32,
                      device=roi.device)
    lib = runtime.kernel_lib("me_ssd")
    rc_ = (lib.hevc_ssd_table_deep32 if wide else lib.hevc_ssd_table_deep)(
        roi.data_ptr(), roi.stride(0), orig.data_ptr(), orig.stride(0),
        box.data_ptr(), box.stride(0), out.data_ptr(), size, r, ny, nx,
        shift, mid, runtime.stream_of(roi))
    runtime.check(lib, rc_, "ssd_table_deep")
    return out


def _lam_shift(depth: int) -> int:
    """Rate-term scale: SSD at effective depth ds = min(depth, 10) is
    2^(2*(ds-8)) times the 8-bit-equivalent distortion."""
    return 2 * (min(depth, 10) - 8) if depth > 8 else 0


@functools.lru_cache(maxsize=None)
def _local_only(size: int, r: int, ny: int, nx: int) -> bool:
    """HEVC_TPU_ME_LOCAL_ONLY as the reference sees it: read once when a
    search shape is first traced (me_mxu.py reads it inside the jitted
    program), then fixed for that shape for the life of the process."""
    return bool(os.environ.get("HEVC_TPU_ME_LOCAL_ONLY"))


def _argmin_two_pass_plain(ssd, bits0, lam_q8, *, r, ny, nx, local_only):
    nyx = 2 * r + 1
    n = ny * nx
    dev = ssd.device
    lam = int(lam_q8)
    cost1 = (ssd + ((lam * bits0) >> 8)).reshape(ny, nx, nyx * nyx)
    cp = torch.nn.functional.pad(cost1, (0, 0, 1, 1, 1, 1))
    sm = sum(cp[dy:dy + ny, dx:dx + nx]
             for dy in range(3) for dx in range(3))
    idxr = torch.argmin(sm.reshape(n, -1), dim=1)
    pny = (idxr // nyx - r).to(torch.int32)
    pnx = (idxr % nyx - r).to(torch.int32)
    d = torch.arange(nyx, dtype=torch.int32, device=dev) - r
    dq = d << 2
    bits2 = (mv_bits(dq[None, :, None] - (pny << 2)[:, None, None])
             + mv_bits(dq[None, None, :] - (pnx << 2)[:, None, None]))
    cost2 = ssd + ((lam * bits2) >> 8)
    local = (((d[None, :, None] - pny[:, None, None]).abs() <= LOCAL_W)
             & ((d[None, None, :] - pnx[:, None, None]).abs() <= LOCAL_W))
    masked = torch.where(local, cost2,
                         torch.full_like(cost2, 1 << 30)).reshape(n, -1)
    idx_loc = torch.argmin(masked, dim=1)
    if local_only:
        return idx_loc.to(torch.int32)
    c_loc = torch.gather(masked, 1, idx_loc[:, None])[:, 0]
    flat2 = cost2.reshape(n, -1)
    idx_g = torch.argmin(flat2, dim=1)
    c_g = torch.gather(flat2, 1, idx_g[:, None])[:, 0]
    return torch.where(c_g + (c_loc >> 3) < c_loc, idx_g,
                       idx_loc).to(torch.int32)


def _argmin_two_pass(ssd, bits0, lam_q8, *, r, ny, nx, size,
                     local_only=None):
    """Robust two-pass argmin -> [ny*nx] int32 flat (dy, dx) indices.

    Pass 1 (regional): argmin of the cost tables summed over a 3x3 block
    neighbourhood — a smooth predictor field (the role the reference's
    sequential TZ predictor chain plays, TEncSearch::xTZSearch). Pass 2
    (local): per-block argmin within +-LOCAL_W of the regional MV with the
    predictor-centred rate term; the block's own global minimum replaces
    it only when clearly (>12.5%) cheaper. `local_only` defaults to
    _local_only of this table's shape; a shard of a frame passes the
    whole frame's."""
    if local_only is None:
        local_only = _local_only(size, r, ny, nx)
    if ssd.device.type == "cpu":
        return _argmin_two_pass_plain(ssd, bits0, lam_q8, r=r, ny=ny, nx=nx,
                                      local_only=local_only)
    nyx = 2 * r + 1
    runtime.require(ssd, torch.int32, "argmin_two_pass ssd")
    runtime.require(bits0, torch.int32, "argmin_two_pass bits0")
    if ssd.shape != (ny * nx, nyx, nyx) or bits0.shape != (nyx, nyx):
        raise ValueError("argmin_two_pass: bad ssd/bits0 shape")
    if ssd.data_ptr() % 16:
        raise ValueError("argmin_two_pass: ssd must be 16-byte aligned")
    idx = torch.empty(ny * nx, dtype=torch.int32, device=ssd.device)
    lib = runtime.kernel_lib("me_ssd")
    rc = lib.hevc_argmin_two_pass(ssd.data_ptr(), bits0.data_ptr(),
                                  int(lam_q8), r, ny, nx, int(local_only),
                                  idx.data_ptr(), runtime.stream_of(ssd))
    runtime.check(lib, rc, "argmin_two_pass")
    return idx


# ---------------------------------------------------------------------
# weighted prediction (reference me_mxu.wp_apply, wp_operand)
# ---------------------------------------------------------------------
def wp_apply_plain(plane: torch.Tensor, wpv, depth: int) -> torch.Tensor:
    """Plain version of the wp_apply kernel: clip(((s * w + rnd) >> d)
    + (o << max(depth - 8, 0)), 0, 2^depth - 1) in int32 with arithmetic
    shifts, rnd = 1 << (d - 1) for d > 0 and 0 for d = 0, cast back to the
    plane's dtype."""
    w, o, d = (int(v) for v in wpv)
    rnd = (1 << (d - 1)) if d > 0 else 0
    v = ((plane.to(torch.int32) * w + rnd) >> d) + (o << max(depth - 8, 0))
    return v.clamp(0, (1 << depth) - 1).to(plane.dtype)


# planes one wp_apply launch takes (kWpMax of csrc/me_refine.cu); a
# picture with more references takes a launch per WP_MAX
WP_MAX = 8


def wp_apply_multi_plain(planes, wpvs, depth: int) -> list:
    """Plain version of wp_apply_multi: wp_apply_plain of each plane."""
    return [wp_apply_plain(p, w, depth) for p, w in zip(planes, wpvs)]


def _wp_kernel_triple(wpv, depth: int):
    """(w, d, off) of a (w, o, denom) triple as the kernel takes them."""
    w, o, d = (int(v) for v in wpv)
    off = o << max(depth - 8, 0)
    if not (0 <= d <= 30 and -(1 << 31) <= w < (1 << 31)
            and -(1 << 31) <= off < (1 << 31)):
        raise ValueError(f"wp_apply: weight triple {wpv} out of range")
    return w, d, off


def wp_apply_multi(planes, wpvs, depth: int) -> list:
    """The weighted-prediction transform of several reference planes, each
    with its own (w, o, denom) triple, into new planes (the reference maps
    wp_apply over a picture's references, me_mxu.py lax.map). On the card
    one launch of the wp_apply kernel over all of them: at most WP_MAX
    uint8 (8-bit), int16 (9-14 bits) or int32 (15-16 bits) planes
    (me_dtype), of any size and alignment."""
    planes = list(planes)
    if len(wpvs) != len(planes):
        raise ValueError("wp_apply_multi: one triple a plane")
    if not planes:
        return []
    if planes[0].device.type == "cpu":
        return wp_apply_multi_plain(planes, wpvs, depth)
    if len(planes) > WP_MAX:
        raise ValueError(f"wp_apply_multi: {len(planes)} planes, at most "
                         f"{WP_MAX} a launch")
    dt = (torch.uint8 if depth <= 8 else
          torch.int16 if depth <= 14 else torch.int32)
    for p in planes:
        runtime.require(p, dt, "wp_apply plane")
    wdo = [_wp_kernel_triple(t, depth) for t in wpvs]
    outs = [torch.empty_like(p) for p in planes]
    desc = np.array([p.data_ptr() for p in planes]
                    + [o.data_ptr() for o in outs]
                    + [p.numel() for p in planes]
                    + [t[i] for i in range(3) for t in wdo], np.int64)
    lib = runtime.kernel_lib("me_refine")
    rc = lib.hevc_wp_apply_multi(desc.ctypes.data, len(planes),
                                 planes[0].element_size(), depth,
                                 runtime.stream_of(planes[0]))
    runtime.check(lib, rc, "wp_apply")
    return outs


def wp_apply(plane: torch.Tensor, wpv, depth: int) -> torch.Tensor:
    """Weighted-prediction transform of an integer reference plane (the
    integer-pel specialisation of spec 8.5.3.3.4.3): searching on the
    weighted plane makes the SSD the weighted distortion (reference
    TComRdCostWeightPrediction). wpv = (w, o, denom). Returns a new plane:
    the cached reference is shared by other frames. On the card a one-plane
    launch of the wp_apply kernel (wp_apply_multi)."""
    return wp_apply_multi([plane], [wpv], depth)[0]


def wp_operand(wp, nref: int, npad: int) -> np.ndarray:
    """[npad, 3] int32 operand from per-ref (w, o, denom) triples; None
    entries become the identity transform (w = 1, o = 0, d = 0)."""
    v = np.tile(np.array([1, 0, 0], np.int32), (npad, 1))
    for i in range(min(nref, npad)):
        t = wp[i] if wp is not None and i < len(wp) else None
        if t is not None:
            v[i] = (int(t[0]), int(t[1]), int(t[2]))
    return v


# ---------------------------------------------------------------------
# fractional-refine tables (reference me_mxu._build_phases,
# _satd_of_tiles, _refine_direct): the host engine's half- then
# quarter-pel SATD refinement (engine.cpp cost_of, reference
# TEncSearch::xPatternSearchFracDIF) and the 3x3 half-pel minimum of its
# split screen, for every grid block at its integer MV
# ---------------------------------------------------------------------
_LUMA_TAPS = ((0, 0, 0, 64, 0, 0, 0, 0),
              (-1, 4, -10, 58, 17, -5, 1, 0),
              (-1, 4, -11, 40, 40, -11, 4, -1),
              (0, 1, -5, 17, 58, -10, 4, -1))
# host refine orders: dy outer, dx inner, strict <; half-pel steps around
# the integer centre, then quarter-pel steps around the half winner
_HALF_SEQ = [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)
             if (dy, dx) != (0, 0)]
_QUART_SEQ = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
              if (dy, dx) != (0, 0)]


def _hadamard(t: int) -> torch.Tensor:
    """t x t Sylvester Hadamard matrix (t = 4 or 8), float64."""
    h = torch.ones((1, 1), dtype=torch.float64)
    while h.shape[0] < t:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h


def _build_phases_plain(refp: torch.Tensor, depth: int) -> torch.Tensor:
    """[16, Hp-7, Wp-7] int32 planes of clipped prediction samples, one per
    (fy, fx) phase (index fy*4+fx); plane (y', x') is the predicted sample
    at padded coordinate (y'+3, x'+3). The shifts come in the reference's
    order: the first pass is shifted by 6 - hr before the second, which
    keeps 14-bit samples inside int32."""
    hr = max(2, 14 - depth)
    s1 = 6 - hr
    off_u = 1 << (hr - 1)
    maxv = (1 << depth) - 1
    p0 = refp.to(torch.int32)
    hp, wp = p0.shape
    w2, h2 = wp - 7, hp - 7

    def hfilt(fx):
        acc = _LUMA_TAPS[fx][0] * p0[:, 0:w2]
        for k in range(1, 8):
            if _LUMA_TAPS[fx][k]:
                acc = acc + _LUMA_TAPS[fx][k] * p0[:, k:k + w2]
        return acc >> s1

    def vfilt(x, fy):
        acc = _LUMA_TAPS[fy][0] * x[0:h2]
        for k in range(1, 8):
            if _LUMA_TAPS[fy][k]:
                acc = acc + _LUMA_TAPS[fy][k] * x[k:k + h2]
        return acc

    def finish(v):
        return ((v + off_u) >> hr).clamp(0, maxv)

    hs = {fx: hfilt(fx) for fx in (1, 2, 3)}
    planes = []
    for fy in range(4):
        for fx in range(4):
            if fy == 0 and fx == 0:
                planes.append(p0[3:3 + h2, 3:3 + w2])
            elif fy == 0:
                planes.append(finish(hs[fx][3:3 + h2]))
            elif fx == 0:
                planes.append(finish(vfilt(p0[:, 3:3 + w2], fy) >> s1))
            else:
                planes.append(finish(vfilt(hs[fx], fy) >> 6))
    return torch.stack(planes)


def _satd_of_tiles_plain(ob: torch.Tensor, tiles: torch.Tensor,
                         size: int) -> torch.Tensor:
    """dsp::satd of [n, size, size] prediction tiles against the per-block
    originals ob: per 8x8 tile (s + 2) >> 2 of s = sum |H d H^T| (the 4x4
    variant, (s + 1) >> 1, below 8), summed over the tiles. The transform
    runs in float64, exact for these sums (|s| < 2^27 through 16 bits)."""
    t = 8 if size >= 8 else 4
    nt = size // t
    h = _hadamard(t).to(ob.device)
    n = ob.shape[0]
    d = ((ob - tiles).reshape(n, nt, t, nt, t).permute(0, 1, 3, 2, 4)
         .to(torch.float64))
    m = torch.einsum("ab,nstbc,dc->nstad", h, d, h)
    s = m.abs().sum(dim=(3, 4)).to(torch.int32)
    per = (s + (2 if t == 8 else 1)) >> (2 if t == 8 else 1)
    return per.sum(dim=(1, 2), dtype=torch.int32)


def _refine_setup(orig, gidx, *, size, r, ny, nx, pad):
    """Per-block originals [n, size, size] int32 and the phase-plane row
    and column [n] of each block's tile at its integer MV: plane (y', x')
    is padded (y'+3, x'+3), so the tile of quarter offset q starts at
    plane row pad + BY + mvy - 3 + (q >> 2)."""
    nyx = 2 * r + 1
    dev = orig.device
    g = gidx.to(torch.int64)
    mvy = torch.div(g, nyx, rounding_mode="floor") - r
    mvx = g % nyx - r
    bx = (torch.arange(nx, device=dev) * size).repeat(ny)
    by = (torch.arange(ny, device=dev) * size).repeat_interleave(nx)
    return (_blocks(orig, size, ny, nx), pad + by + mvy - 3,
            pad + bx + mvx - 3)


def _slice_start(s: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """A start of the reference's lax.dynamic_slice: a negative start
    counts from the end of the axis (JAX's allow_negative_indices), then
    it is clamped so that the slice fits. Starts leave the phase planes
    only for r > pad - 4."""
    return torch.where(s < 0, s + dim, s).clamp(0, dim - size)


def _phase_tiles(phases, pidx, r0, c0, size):
    """[n, size, size] tiles of phases[pidx] at (r0, c0) per block, with
    the reference's slice starts (_slice_start)."""
    _, h2, w2 = phases.shape
    ar = torch.arange(size, device=phases.device)
    rows = _slice_start(r0, h2, size)[:, None] + ar
    cols = _slice_start(c0, w2, size)[:, None] + ar
    if isinstance(pidx, int):
        return phases[pidx][rows[:, :, None], cols[:, None, :]]
    return phases[pidx[:, None, None], rows[:, :, None], cols[:, None, :]]


def _refine_half_plain(ob, phases, base_r, base_c, size):
    """The half stage: (best cost, cy, cx, 3x3 half minimum) [n] of the
    9 half-pel candidates, strict < in _HALF_SEQ order."""
    hvals = {}
    for dy in (-2, 0, 2):
        for dx in (-2, 0, 2):
            tiles = _phase_tiles(phases, (dy & 3) * 4 + (dx & 3),
                                 base_r + (dy >> 2), base_c + (dx >> 2),
                                 size)
            hvals[(dy, dx)] = _satd_of_tiles_plain(ob, tiles, size)
    bc = hvals[(0, 0)]
    cy = torch.zeros_like(bc, dtype=torch.int64)
    cx = torch.zeros_like(cy)
    for dy, dx in _HALF_SEQ:
        c = hvals[(dy, dx)]
        take = c < bc
        bc = torch.where(take, c, bc)
        cy = torch.where(take, dy, cy)
        cx = torch.where(take, dx, cx)
    half_min = torch.stack(list(hvals.values())).amin(dim=0)
    return bc, cy, cx, half_min


def _refine_direct_plain(orig, phases, gidx, *, size, r, ny, nx, pad):
    """Plain version of the refine_tables kernel on prebuilt phase planes:
    (packed quarter offset (by+3)*7 + (bx+3), 3x3 half minimum), int32
    [ny*nx]: the 9 half-pel candidates, then the 8 quarter-pel ones
    around the half winner (_QUART_SEQ, strict <)."""
    ob, base_r, base_c = _refine_setup(orig, gidx, size=size, r=r, ny=ny,
                                       nx=nx, pad=pad)
    bc, cy, cx, half_min = _refine_half_plain(ob, phases, base_r, base_c,
                                              size)
    by, bx = cy, cx
    for dy, dx in _QUART_SEQ:
        qy, qx = cy + dy, cx + dx
        tiles = _phase_tiles(phases, (qy & 3) * 4 + (qx & 3),
                             base_r + (qy >> 2), base_c + (qx >> 2), size)
        c = _satd_of_tiles_plain(ob, tiles, size)
        take = c < bc
        bc = torch.where(take, c, bc)
        by = torch.where(take, qy, by)
        bx = torch.where(take, qx, bx)
    return ((by + 3) * 7 + (bx + 3)).to(torch.int32), half_min


def refine_tables(orig, refp, gidx, *, size, r, ny, nx, pad, depth):
    """Fractional-refine tables of one grid against one reference:
    (off, half) int32 [ny*nx], the packed quarter offset of the host's
    two-stage refinement around each block's integer MV (gidx, the flat
    argmin indices of me_idx_frame) and the minimum of its 3x3 half-pel
    SATDs. orig [H, W] and refp [H+2pad, W+2pad] as me_idx_frame takes
    them. On the card one launch of the refine_tables kernel (sizes 16 and
    32): uint8 planes at 8 bits and int16 ones at 9-14 bits take its
    float32 instances, int32 planes at 15-16 bits its int32 instance
    (me_dtype); any other pairing of dtype and depth raises ValueError."""
    if refp.device.type == "cpu":
        return _refine_direct_plain(orig, _build_phases_plain(refp, depth),
                                    gidx, size=size, r=r, ny=ny, nx=nx,
                                    pad=pad)
    if size not in (16, 32):
        raise ValueError(f"refine_tables: block size {size} is not 16 or "
                         "32")
    if not 8 <= depth <= 16:
        raise ValueError(f"refine_tables: {depth}-bit samples (8-16 bits)")
    dt = (torch.uint8 if depth == 8 else
          torch.int16 if depth <= 14 else torch.int32)
    runtime.require(orig, dt, "refine_tables orig", contiguous=False)
    runtime.require(refp, dt, "refine_tables refp", contiguous=False)
    runtime.require(gidx, torch.int32, "refine_tables gidx")
    hp, wp = refp.shape
    if (orig.stride(1) != 1 or refp.stride(1) != 1
            or gidx.shape != (ny * nx,) or ny * nx == 0
            or orig.shape[0] < ny * size or orig.shape[1] < nx * size
            or hp < size + 8 or wp < size + 8):
        raise ValueError("refine_tables: bad orig/refp/gidx shape or "
                         "layout")
    off = torch.empty(ny * nx, dtype=torch.int32, device=refp.device)
    half = torch.empty_like(off)
    lib = runtime.kernel_lib("me_refine")
    rc = lib.hevc_refine_tables(
        orig.data_ptr(), orig.stride(0), refp.data_ptr(), refp.stride(0),
        hp, wp, refp.element_size(), gidx.data_ptr(), size, r, ny, nx, pad,
        depth, off.data_ptr(), half.data_ptr(), runtime.stream_of(refp))
    runtime.check(lib, rc, "refine_tables")
    return off, half


def me_idx_frame(orig, ref_padded, bits0, lam_q8, *, size, r, ny, nx, pad,
                 depth=8, wpv=None, local_only=None):
    """One frame's two-pass SSD argmin indices [ny*nx] int32 for one
    reference: orig [H, W] and ref_padded [H+2pad, W+2pad] tensors, uint8
    at 8 bits, int16 at 9-14 bits, int32 at 15-16 bits (me_dtype). `wpv`,
    when given, is the (w, o, denom) weighted-prediction triple applied to
    the reference before the search (wp_apply). `local_only`: as
    _argmin_two_pass takes it."""
    if wpv is not None:
        ref_padded = wp_apply(ref_padded, wpv, depth)
    aw = 2 * r + size
    roi = ref_padded[pad - r:pad - r + (ny - 1) * size + aw,
                     pad - r:pad - r + (nx - 1) * size + aw]
    if depth > 8:
        ssd = _ssd_table_deep(roi, orig, size=size, r=r, ny=ny, nx=nx,
                              depth=depth)
        lam_q8 = lam_q8 << _lam_shift(depth)
    else:
        ssd = _ssd_table(roi, orig, size=size, r=r, ny=ny, nx=nx)
    return _argmin_two_pass(ssd, bits0, lam_q8, r=r, ny=ny, nx=nx,
                            size=size, local_only=local_only)


def _grid_dims(h: int, w: int, size: int):
    ny = (h - size) // size + 1 if h >= size else 0
    nx = (w - size) // size + 1 if w >= size else 0
    return ny, nx


def _grids(idx: np.ndarray, r: int, ny: int, nx: int):
    nyx = 2 * r + 1
    gy = (idx // nyx - r).astype(np.int32).reshape(ny, nx)
    gx = (idx % nyx - r).astype(np.int32).reshape(ny, nx)
    return gx, gy


def me_grids_multi2(orig_dev, ref_devs, size: int, size2: int, r: int,
                    lam_fp: int, *, pad: int, depth: int = 8,
                    mesh=None, wp=None, refine: bool = False):
    """MV grids at the CU-grid size AND its half size for several
    references. Returns [(gx, gy, gx2, gy2)] per reference; any grid whose
    dimension is empty is (None, None). wp: per-ref (w, o, denom) luma
    weighted-prediction triples (or None entries): the search then runs
    against the weighted reference. refine: also the fractional-refine
    tables, as a fifth entry {"off32", "half32", "off16", "half16"}.
    mesh: a parallel.Mesh whose devices split every grid's block rows
    (parallel.me_idx_blocks_async); the grids are the unsharded ones."""
    return me_grids_multi2_async(orig_dev, ref_devs, size, size2, r,
                                 lam_fp, pad=pad, depth=depth, mesh=mesh,
                                 wp=wp, refine=refine)()


def me_grids_multi2_async(orig_dev, ref_devs, size: int, size2: int,
                          r: int, lam_fp: int, *, pad: int,
                          depth: int = 8, mesh=None, wp=None,
                          refine: bool = False):
    """Launch the two-grid multi-reference search and return a zero-arg
    collector. Kernel launches are asynchronous, and the packed indices
    of every reference and both grids come back in one device-to-host
    copy started right behind them, so between launch and collect the
    device computes under whatever host work runs (the encoder's one-frame
    lookahead hides the integer search under the previous frame's CU
    engine and entropy coding).

    The reference pads the reference count to 1/2/4/8 so that XLA compiles
    one program per count; eager PyTorch has nothing to compile, and the
    padded slots' results were discarded, so only the real references are
    searched.

    Under weighted prediction every reference is transformed, all of them
    in one wp_apply_multi launch before the search (None entries by the
    identity, as the reference's operand makes them), and the refine
    tables are not computed: the host's WP-aware MC differs from plane
    weighting. When only one of the two grids fits the picture,
    the search runs unweighted and without tables, as the reference's
    single-grid fallback does. Under a mesh each device searches its
    shard of block rows (one readback a device) and the tables are not
    computed, as the reference computes none under a mesh."""
    h, w = orig_dev.shape[:2]
    r2 = min(r, 16)
    ny, nx = _grid_dims(h, w, size)
    ny2, nx2 = _grid_dims(h, w, size2)
    if ny2 == 0 or nx2 == 0:
        out = [(gx, gy, None, None) for gx, gy in
               me_grids_multi(orig_dev, ref_devs, size, r, lam_fp,
                              pad=pad, depth=depth, mesh=mesh)]
        return lambda: out
    if ny == 0 or nx == 0:
        # picture smaller than the large grid: only the small grid runs
        out = [(None, None, gx, gy) for gx, gy in
               me_grids_multi(orig_dev, ref_devs, size2, r2, lam_fp,
                              pad=pad, depth=depth, mesh=mesh)]
        return lambda: out
    lam_q8 = lam_q8_of(lam_fp)
    use_wp = wp is not None and any(t is not None for t in wp)
    refs = list(ref_devs)
    if use_wp:
        refine = False  # host WP-aware MC differs from plane weighting
        wpvs = wp_operand(wp, len(refs), len(refs))
        refs = [t for i in range(0, len(refs), WP_MAX)
                for t in wp_apply_multi(refs[i:i + WP_MAX],
                                        wpvs[i:i + WP_MAX], depth)]
    n1, n2 = ny * nx, ny2 * nx2
    if mesh is not None:
        from ..parallel import me_idx_blocks_async
        refine = False
        result = me_idx_blocks_async(
            orig_dev, refs, [(size, r, ny, nx), (size2, r2, ny2, nx2)],
            lam_q8, mesh=mesh, pad=pad, depth=depth)
    else:
        result = _me_idx_multi2_dev(orig_dev, refs, size, size2, r, r2,
                                    (ny, nx, ny2, nx2), lam_q8, pad=pad,
                                    depth=depth, refine=refine).result

    def collect():
        a = result()
        out = []
        for k in range(len(refs)):
            grids = (_grids(a[k, :n1], r, ny, nx)
                     + _grids(a[k, n1:n1 + n2], r2, ny2, nx2))
            if refine:
                # packed quarter-refine offsets and 3x3 half-pel minima of
                # both grids, in the order they were concatenated
                t = np.split(a[k, n1 + n2:], np.cumsum([n1, n1, n2]))
                grids += ({"off32": t[0].reshape(ny, nx),
                           "half32": t[1].reshape(ny, nx),
                           "off16": t[2].reshape(ny2, nx2),
                           "half16": t[3].reshape(ny2, nx2)},)
            out.append(grids)
        return out
    return collect


def _me_idx_multi2_dev(orig_dev, refs, size, size2, r, r2, dims, lam_q8, *,
                       pad, depth, refine):
    """Both grids' indices (and with `refine` their tables) of every
    reference on orig_dev's device, [len(refs), n1 + n2 (+ 2 n1 + 2 n2)]
    int32, its copy to the host started (a runtime.Readback)."""
    ny, nx, ny2, nx2 = dims
    dev = orig_dev.device
    parts = []
    for refp in refs:
        i1 = me_idx_frame(orig_dev, refp, _bits0_dev(r, dev), lam_q8,
                          size=size, r=r, ny=ny, nx=nx, pad=pad, depth=depth)
        i2 = me_idx_frame(orig_dev, refp, _bits0_dev(r2, dev), lam_q8,
                          size=size2, r=r2, ny=ny2, nx=nx2, pad=pad,
                          depth=depth)
        part = [i1, i2]
        if refine:
            rk = dict(pad=pad, depth=depth)
            part += refine_tables(orig_dev, refp, i1, size=size, r=r, ny=ny,
                                  nx=nx, **rk)
            part += refine_tables(orig_dev, refp, i2, size=size2, r=r2,
                                  ny=ny2, nx=nx2, **rk)
        parts.append(torch.cat(part))
    return runtime.Readback(torch.stack(parts))


def me_grids_multi(orig_dev, ref_devs, size: int, r: int, lam_fp: int, *,
                   pad: int, depth: int = 8, mesh=None):
    """(gx, gy) MV grids for several references (the reference searches
    each refIdx separately, TEncSearch.cpp:3027); under a mesh each device
    searches its shard of block rows."""
    h, w = orig_dev.shape[:2]
    ny, nx = _grid_dims(h, w, size)
    if ny == 0 or nx == 0:
        return [(None, None)] * len(ref_devs)
    dev = orig_dev.device
    lam_q8 = lam_q8_of(lam_fp)
    if mesh is not None:
        from ..parallel import me_idx_blocks_async
        a = me_idx_blocks_async(orig_dev, list(ref_devs), [(size, r, ny, nx)],
                                lam_q8, mesh=mesh, pad=pad, depth=depth)()
        return [_grids(a[k], r, ny, nx) for k in range(len(ref_devs))]
    idx = torch.stack([
        me_idx_frame(orig_dev, refp, _bits0_dev(r, dev), lam_q8, size=size,
                     r=r, ny=ny, nx=nx, pad=pad, depth=depth)
        for refp in ref_devs])
    a = runtime.Readback(idx).result()
    return [_grids(a[k], r, ny, nx) for k in range(len(ref_devs))]


def me_grid_ssd(orig_y, ref_padded_y, size: int, r: int, lam_fp: int, *,
                pad: int, depth: int = 8):
    """(gx, gy) int32 MV grids for the aligned block grid of one reference;
    orig_y / ref_padded_y are tensors on the device."""
    return me_grids_multi(orig_y, [ref_padded_y], size, r, lam_fp, pad=pad,
                          depth=depth)[0]


# ---------------------------------------------------------------------
# numpy twin (the reference's host path; bit-identical decisions)
# ---------------------------------------------------------------------
def _ssd_np(areas, blks, size, nyx, mid=128):
    """Exact SSD tables on the host, via the same decomposition as the
    device path (window energy + block energy - 2*correlation). The
    correlation runs as per-row einsums over x-windows in float64 —
    exact whenever |sums| << 2^53."""
    n = areas.shape[0]
    a = (areas - mid).astype(np.float64)
    b = (blks - mid).astype(np.float64)
    av = np.lib.stride_tricks.sliding_window_view(a, size, axis=2)
    corr = np.zeros((n, nyx, nyx))
    for r in range(size):
        corr += np.einsum('nyxc,nc->nyx', av[:, r:r + nyx, :nyx, :],
                          b[:, r, :], optimize=True)
    corr = np.rint(corr).astype(np.int64)
    a2 = ((areas - mid) ** 2).astype(np.int64)
    ii = np.pad(a2.cumsum(axis=1).cumsum(axis=2),
                ((0, 0), (1, 0), (1, 0)))
    win = (ii[:, size:size + nyx, size:size + nyx]
           - ii[:, :nyx, size:size + nyx]
           - ii[:, size:size + nyx, :nyx] + ii[:, :nyx, :nyx])
    b2 = ((blks - mid) ** 2).sum((1, 2))[:, None, None]
    return (win + b2 - 2 * corr).astype(np.int32)


def me_grid_ssd_np(orig_y, ref_padded_y, size: int, r: int, lam_fp: int, *,
                   pad: int, depth: int = 8):
    h, w = orig_y.shape[:2]
    ny, nx = _grid_dims(h, w, size)
    if ny == 0 or nx == 0:
        return None, None
    nyx = 2 * r + 1
    n = ny * nx
    aw = 2 * r + size
    shift, mid = deep_centring(depth) if depth > 8 else (0, 128)
    blks = ((orig_y[:ny * size, :nx * size].astype(np.int64) >> shift)
            .reshape(ny, size, nx, size).transpose(0, 2, 1, 3)
            .reshape(n, size, size))
    winv = np.lib.stride_tricks.sliding_window_view(
        ref_padded_y.astype(np.int64) >> shift, (aw, aw))[pad - r::size,
                                                          pad - r::size]
    areas = winv[:ny, :nx].reshape(n, aw, aw)
    ssd = _ssd_np(areas, blks, size, nyx, mid=mid)
    lam = lam_q8_of(lam_fp) << _lam_shift(depth)

    def bits_of(v):
        t = np.where(v <= 0, ((-v) << 1) + 1, v << 1).astype(np.int64)
        return (2 * np.floor(np.log2(t)).astype(np.int32) + 1)

    d = np.arange(nyx, dtype=np.int64) - r
    b1 = bits_of(d << 2)
    bits0 = (b1[:, None] + b1[None, :]).astype(np.int32)
    cost1 = (ssd + ((lam * bits0[None]) >> 8).astype(np.int32)
             ).reshape(ny, nx, nyx * nyx)
    cp = np.pad(cost1, ((1, 1), (1, 1), (0, 0)))
    sm = sum(cp[dy:dy + ny, dx:dx + nx]
             for dy in range(3) for dx in range(3))
    idxr = np.argmin(sm.reshape(n, -1), axis=1)
    pny = (idxr // nyx - r).astype(np.int64)
    pnx = (idxr % nyx - r).astype(np.int64)
    bits2 = (bits_of((d << 2)[None, :, None] - (pny << 2)[:, None, None])
             + bits_of((d << 2)[None, None, :] - (pnx << 2)[:, None, None]))
    cost2 = ssd + ((lam * bits2) >> 8).astype(np.int32)
    local = ((np.abs(d[None, :, None] - pny[:, None, None]) <= LOCAL_W)
             & (np.abs(d[None, None, :] - pnx[:, None, None]) <= LOCAL_W))
    big = np.int32(1 << 30)
    masked = np.where(local, cost2, big).reshape(n, -1)
    idx_loc = np.argmin(masked, axis=1)
    c_loc = masked[np.arange(n), idx_loc]
    flat2 = cost2.reshape(n, -1)
    idx_g = np.argmin(flat2, axis=1)
    c_g = flat2[np.arange(n), idx_g]
    if os.environ.get("HEVC_TPU_ME_LOCAL_ONLY"):
        idx2 = idx_loc
    else:
        idx2 = np.where(c_g + (c_loc >> 3) < c_loc, idx_g, idx_loc)
    gy = (idx2 // nyx - r).astype(np.int32).reshape(ny, nx)
    gx = (idx2 % nyx - r).astype(np.int32).reshape(ny, nx)
    return gx, gy
