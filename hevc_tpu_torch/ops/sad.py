"""Full-search SAD tables: the CUDA kernel and its plain PyTorch version.

Counterpart of hevc_tpu/ops/sad_pallas.py (the Pallas TPU kernel
``_sad_kernel`` / ``sad_table``, and its planes-in variants
``sad_table_from_planes`` / ``me_from_planes``) and of hevc_tpu/ops/me.py
``full_search_batch_pallas`` (the table and its cost + argmin epilogue, one
fused kernel here; ``cost_argmin`` is the epilogue alone). The kernels are
in ``csrc/sad.cu``; the note there says what bounds them.

A wrapper runs its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from .. import runtime
from .me import full_search_batch, mv_bits


def _search_shape(blks, areas, name):
    """(n, h, w, ny, nx) of blocks [N, h, w] and their search areas
    [N, h+ny-1, w+nx-1], both int32 on the card; raises otherwise."""
    runtime.require(blks, torch.int32, f"{name} blks")
    runtime.require(areas, torch.int32, f"{name} areas")
    n, h, w = blks.shape
    if (areas.dim() != 3 or areas.shape[0] != n or areas.shape[1] < h
            or areas.shape[2] < w):
        raise ValueError(f"{name}: areas must be [N, h+ny-1, w+nx-1]")
    return n, h, w, areas.shape[1] - h + 1, areas.shape[2] - w + 1


def _search_vectors(n, tensors, name):
    """Check the [N] int32 per-block vectors of a search on the card."""
    for t, what in zip(tensors, ("mv_min_y", "mv_min_x", "pred_qy",
                                 "pred_qx")):
        runtime.require(t, torch.int32, f"{name} {what}")
        if t.shape != (n,):
            raise ValueError(f"{name}: {what} must be [N]")


def sad_table_plain(blks: torch.Tensor, areas: torch.Tensor) -> torch.Tensor:
    """blks [N,h,w], areas [N,h+ny-1,w+nx-1] (int) -> SAD [N,ny,nx] int32,
    one block sample at a time (exact int32 accumulation)."""
    n, h, w = blks.shape
    ny = areas.shape[1] - h + 1
    nx = areas.shape[2] - w + 1
    a = areas.to(torch.int32)
    b = blks.to(torch.int32)
    out = torch.zeros((n, ny, nx), dtype=torch.int32, device=blks.device)
    for i in range(h):
        for j in range(w):
            out += (a[:, i:i + ny, j:j + nx] - b[:, i, j, None, None]).abs_()
    return out


def sad_table(blks: torch.Tensor, areas: torch.Tensor) -> torch.Tensor:
    """SAD tables [N, ny, nx] int32 of int32 blocks [N, h, w] against their
    search areas [N, h+ny-1, w+nx-1] (sad_pallas.sad_table)."""
    if blks.device.type == "cpu":
        return sad_table_plain(blks, areas)
    n, h, w, ny, nx = _search_shape(blks, areas, "sad_table")
    out = torch.empty((n, ny, nx), dtype=torch.int32, device=blks.device)
    lib = runtime.kernel_lib("sad")
    rc = lib.hevc_sad_table(blks.data_ptr(), areas.data_ptr(),
                            out.data_ptr(), n, h, w, ny, nx,
                            runtime.stream_of(blks))
    runtime.check(lib, rc, "sad_table")
    return out


def cost_argmin_plain(sads, mv_min_y, mv_min_x, pred_qy, pred_qx,
                      lam_fp: int):
    """cost = sad + (lam_fp * bits) >> 16 and its first row-major minimum
    per block -> (mv_y, mv_x, cost, sad), each [N] int32."""
    n, ny, nx = sads.shape
    dev = sads.device
    mv_y = mv_min_y[:, None, None] + torch.arange(
        ny, dtype=torch.int32, device=dev)[None, :, None]
    mv_x = mv_min_x[:, None, None] + torch.arange(
        nx, dtype=torch.int32, device=dev)[None, None, :]
    bits = (mv_bits((mv_y << 2) - pred_qy[:, None, None])
            + mv_bits((mv_x << 2) - pred_qx[:, None, None]))
    cost = sads + ((int(lam_fp) * bits) >> 16)
    flat = cost.reshape(n, ny * nx)
    idx = torch.argmin(flat, dim=1)          # first minimum wins
    take = lambda a: torch.gather(a.reshape(n, ny * nx), 1,
                                  idx[:, None])[:, 0].to(torch.int32)
    return (mv_min_y + (idx // nx).to(torch.int32),
            mv_min_x + (idx % nx).to(torch.int32), take(cost), take(sads))


def cost_argmin(sads, mv_min_y, mv_min_x, pred_qy, pred_qx, lam_fp: int):
    """Fused lambda*mv-bits cost and first-minimum argmin over SAD tables
    [N, ny, nx] (the XLA epilogue of me.full_search_batch_pallas)."""
    if sads.device.type == "cpu":
        return cost_argmin_plain(sads, mv_min_y, mv_min_x, pred_qy, pred_qx,
                                 lam_fp)
    runtime.require(sads, torch.int32, "cost_argmin sads")
    n, ny, nx = sads.shape
    vecs = (mv_min_y, mv_min_x, pred_qy, pred_qx)
    _search_vectors(n, vecs, "cost_argmin")
    outs = [torch.empty(n, dtype=torch.int32, device=sads.device)
            for _ in range(4)]
    lib = runtime.kernel_lib("sad")
    rc = lib.hevc_sad_cost_argmin(
        sads.data_ptr(), *[t.data_ptr() for t in vecs], _lam32(lam_fp), n,
        ny, nx, *[o.data_ptr() for o in outs], runtime.stream_of(sads))
    runtime.check(lib, rc, "sad_cost_argmin")
    return tuple(outs)


def full_search_batch_kernel(blks, areas, mv_min_y, mv_min_x, pred_qy,
                             pred_qx, lam_fp: int):
    """The fallback inter path's full search (me.full_search_batch_pallas):
    the SAD of every offset, cost = sad + (lam_fp * mv_bits) >> 16 and the
    first row-major minimum. Returns (mv_y, mv_x, cost, sad), each [N]
    int32. On the card one launch, which writes no table; on the CPU the
    plain me.full_search_batch."""
    if blks.device.type == "cpu":
        return full_search_batch(blks, areas, mv_min_y, mv_min_x, pred_qy,
                                 pred_qx, lam_fp)
    n, h, w, ny, nx = _search_shape(blks, areas, "full_search")
    vecs = (mv_min_y, mv_min_x, pred_qy, pred_qx)
    _search_vectors(n, vecs, "full_search")
    outs = [torch.empty(n, dtype=torch.int32, device=blks.device)
            for _ in range(4)]
    lib = runtime.kernel_lib("sad")
    rc = lib.hevc_full_search(
        blks.data_ptr(), areas.data_ptr(), *[t.data_ptr() for t in vecs],
        _lam32(lam_fp), n, h, w, ny, nx, *[o.data_ptr() for o in outs],
        runtime.stream_of(blks))
    runtime.check(lib, rc, "full_search")
    return tuple(outs)


# sample dtypes the planes kernels read (me_ssd.me_dtype gives the first
# three); the value is the C entry's `sample` code
_PLANE_SAMPLES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}


def _bucket(n: int) -> int:
    """Rows of a planes table: the power-of-two bucket >= max(n, 128)."""
    return max(128, 1 << (n - 1).bit_length())


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (XLA's int32 arithmetic)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _check_planes(ref_padded, orig, size, r, ny, nx, pad):
    """The shapes sad_pallas.sad_table_from_planes slices without checking:
    raise where its windows or blocks would leave the planes."""
    aw = 2 * r + size
    if ref_padded.dim() != 2 or orig.dim() != 2:
        raise ValueError("planes: ref_padded and orig must be 2-D planes")
    if ny < 1 or nx < 1 or size < 1 or r < 0:
        raise ValueError("planes: empty block grid or negative range")
    if pad < r:
        raise ValueError(f"planes: pad {pad} < search range {r}")
    if (ref_padded.shape[0] < pad - r + (ny - 1) * size + aw
            or ref_padded.shape[1] < pad - r + (nx - 1) * size + aw):
        raise ValueError("planes: ref_padded too small for the windows")
    if orig.shape[0] < ny * size or orig.shape[1] < nx * size:
        raise ValueError("planes: orig too small for the block grid")


def sad_table_from_planes_plain(ref_padded, orig, *, size, r, ny, nx, pad):
    """Plain version: gather the blocks and their windows as int32 tensors
    (as the reference does), pad to the bucket with zeros, sad_table_plain."""
    _check_planes(ref_padded, orig, size, r, ny, nx, pad)
    aw = 2 * r + size
    n = ny * nx
    blks = (orig[:ny * size, :nx * size].to(torch.int32)
            .reshape(ny, size, nx, size).permute(0, 2, 1, 3)
            .reshape(n, size, size))
    roi = ref_padded[pad - r:pad - r + (ny - 1) * size + aw,
                     pad - r:pad - r + (nx - 1) * size + aw].to(torch.int32)
    areas = roi.unfold(0, aw, size).unfold(1, aw, size).reshape(n, aw, aw)
    pad_n = _bucket(n) - n
    blks = torch.nn.functional.pad(blks, (0, 0, 0, 0, 0, pad_n))
    areas = torch.nn.functional.pad(areas, (0, 0, 0, 0, 0, pad_n))
    return sad_table_plain(blks, areas)


def _plane_args(ref_padded, orig, name):
    code = _PLANE_SAMPLES.get(ref_padded.dtype)
    if code is None or orig.dtype != ref_padded.dtype:
        raise ValueError(f"{name}: ref_padded and orig must share one of "
                         f"{sorted(map(str, _PLANE_SAMPLES))}, got "
                         f"{ref_padded.dtype} / {orig.dtype}")
    for t, what in ((ref_padded, "ref_padded"), (orig, "orig")):
        runtime.require(t, t.dtype, f"{name} {what}", contiguous=False)
        if t.stride(1) != 1:
            raise ValueError(f"{name}: {what} needs unit column stride")
    return (ref_padded.data_ptr(), ref_padded.stride(0), orig.data_ptr(),
            orig.stride(0), code)


def sad_table_from_planes(ref_padded: torch.Tensor, orig: torch.Tensor, *,
                          size: int, r: int, ny: int, nx: int,
                          pad: int) -> torch.Tensor:
    """Full-search SAD tables [bucket, 2r+1, 2r+1] int32 of the aligned
    size x size block grid of `orig` [H, W], each block against its window
    of `ref_padded` [H+2pad, W+2pad] (sad_pallas.sad_table_from_planes).
    bucket = max(128, next power of two >= ny*nx); padded rows are 0."""
    if ref_padded.device.type == "cpu":
        return sad_table_from_planes_plain(ref_padded, orig, size=size, r=r,
                                           ny=ny, nx=nx, pad=pad)
    _check_planes(ref_padded, orig, size, r, ny, nx, pad)
    args = _plane_args(ref_padded, orig, "sad_table_from_planes")
    nyx = 2 * r + 1
    bucket = _bucket(ny * nx)
    out = torch.empty((bucket, nyx, nyx), dtype=torch.int32,
                      device=ref_padded.device)
    lib = runtime.kernel_lib("sad")
    rc = lib.hevc_sad_table_planes(*args, out.data_ptr(), size, r, ny, nx,
                                   pad, bucket, runtime.stream_of(orig))
    runtime.check(lib, rc, "sad_table_planes")
    return out


def me_from_planes_plain(ref_padded, orig, bits, lam_fp, *, size, r, ny,
                         nx, pad):
    """Plain version: the SAD tables, cost = sad + ((lam_fp * bits) >> 16)
    in wrapping int32, and the first row-major minimum per row."""
    sads = sad_table_from_planes_plain(ref_padded, orig, size=size, r=r,
                                       ny=ny, nx=nx, pad=pad)
    rate = _wrap32(_lam32(lam_fp) * bits.to(torch.int64)) >> 16
    cost = _wrap32(sads.to(torch.int64) + rate.to(torch.int64)[None])
    return torch.argmin(cost.reshape(cost.shape[0], -1),
                        dim=1).to(torch.int32)


def _lam32(lam_fp) -> int:
    """lam_fp (an int or a one-element tensor) as int32, wrapped."""
    return ((int(lam_fp) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def me_from_planes(ref_padded: torch.Tensor, orig: torch.Tensor,
                   bits: torch.Tensor, lam_fp, *, size: int, r: int, ny: int,
                   nx: int, pad: int) -> torch.Tensor:
    """The planes-in full search fused end to end (sad_pallas.
    me_from_planes): per bucket row the first row-major minimum index of
    sad + ((lam_fp * bits) >> 16), bits [2r+1, 2r+1] int32 -> [bucket]
    int32. One launch on the card; no table is written."""
    nyx = 2 * r + 1
    if tuple(bits.shape) != (nyx, nyx):
        raise ValueError(f"me_from_planes: bits must be [{nyx}, {nyx}]")
    if ref_padded.device.type == "cpu":
        return me_from_planes_plain(ref_padded, orig, bits, lam_fp,
                                    size=size, r=r, ny=ny, nx=nx, pad=pad)
    _check_planes(ref_padded, orig, size, r, ny, nx, pad)
    args = _plane_args(ref_padded, orig, "me_from_planes")
    runtime.require(bits, torch.int32, "me_from_planes bits")
    bucket = _bucket(ny * nx)
    idx = torch.empty(bucket, dtype=torch.int32, device=ref_padded.device)
    lib = runtime.kernel_lib("sad")
    rc = lib.hevc_me_planes(*args, bits.data_ptr(), _lam32(lam_fp),
                            idx.data_ptr(), size, r, ny, nx, pad, bucket,
                            runtime.stream_of(orig))
    runtime.check(lib, rc, "me_planes")
    return idx
