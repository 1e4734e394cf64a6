"""Multi-device scaling: the mesh, and the integer motion search split over it.

Counterpart of hevc_tpu/parallel/__init__.py. The reference splits the
search two ways over a jax.sharding.Mesh; here a Mesh is an explicit,
ordered tuple of torch devices, passed to every entry that uses it (there
is no ambient mesh context):

* **frame axis** (`me_grids_frames`, the reference's `_me_frames`): the
  integer search against the *source* previous picture makes every inter
  frame independent, so a batch of frames is cut into one chunk a device,
  and device k runs the per-frame search (ops/me_ssd.me_idx_frame) of
  chunk k.
* **block axis** (`me_grid_spatial`, and every search of
  `EncoderTop(cfg, mesh=...)` through `me_idx_blocks_async`): a grid's
  block rows are cut into one contiguous shard a device. Each device
  computes the SSD tables and the two-pass argmin of its rows plus one
  halo block row on each inner side and keeps its own rows' indices. That
  is exact: the argmin's regional pass reads only the 3x3 block
  neighbourhood, and the frame's outer rows get the unsharded search's
  zero padding. Only the halo rows of the planes travel to a device, and
  only int32 indices come back, one readback a device.

Every device launches on its own current stream. A device may appear more
than once (two shards on one card), and `make_mesh(n, device="cpu")` gives
n CPU entries, on which the kernels' plain versions run.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import runtime
from ..ops import me_ssd
from ..ops.interp import pad_plane

PAD = 80  # must match encoder.native_frame.PAD


# ----------------------------------------------------------------------
# Mesh construction
# ----------------------------------------------------------------------
class Mesh:
    """An ordered tuple of torch devices along one named axis. Devices may
    repeat (several shards on one card)."""

    def __init__(self, devices: Sequence, axis_name: str = "frame"):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(runtime.resolve_device(d) for d in devices)
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_name={self.axis_name!r})")


def make_mesh(n_devices: int, axis_name: str = "frame",
              device="cuda") -> Mesh:
    """An n-device mesh: cuda:0 ... cuda:n-1, or n CPU entries for
    device="cpu". Raises when fewer than n cards are present; it never
    falls back to the CPU."""
    if n_devices < 1:
        raise ValueError(f"a mesh of {n_devices} devices")
    kind = torch.device(device).type
    if kind == "cpu":
        return Mesh(["cpu"] * n_devices, axis_name)
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r}")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have {have}")
    return Mesh([torch.device("cuda", k) for k in range(n_devices)],
                axis_name)


def _on(dev: torch.device):
    """Make `dev` the current device while its shard launches."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _same_device(a, b) -> bool:
    """Whether two device names are one device ("cuda" is the current
    card)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type == "cuda" and None in (a.index, b.index):
        cur = torch.cuda.current_device()
        return ((cur if a.index is None else a.index)
                == (cur if b.index is None else b.index))
    return a == b


# ----------------------------------------------------------------------
# Block axis: one grid's block rows split over the mesh
# ----------------------------------------------------------------------
def row_shards(ny: int, n: int) -> List[Tuple[int, int]]:
    """[(a, b)] the block rows a <= row < b of each of n shards:
    ceil(ny / n) rows each in order, so the last shards may be empty (as
    the reference pads the block count to a multiple of the mesh)."""
    step = -(-ny // n)
    return [(min(k * step, ny), min((k + 1) * step, ny)) for k in range(n)]


def me_idx_blocks_async(orig_dev, refs, grids, lam_q8: int, *, mesh: Mesh,
                        pad: int, depth: int = 8):
    """The two-pass SSD search of every reference on every grid, each
    grid's block rows split over the mesh. orig_dev [H, W] and refs (padded
    [H+2pad, W+2pad], me_dtype(depth)) may lie on any device; grids:
    [(size, r, ny, nx)]. Returns a zero-arg collector of the flat argmin
    indices, int32 [len(refs), sum(ny * nx)] (the grids in order), equal
    to the unsharded search's."""
    grids = list(grids)
    offs = np.cumsum([0] + [ny * nx for _, _, ny, nx in grids])
    shards = [row_shards(ny, mesh.size) for _, _, ny, _ in grids]
    pending = []
    for k, dev in enumerate(mesh.devices):
        pieces, where = [], []
        with _on(dev):
            for g, (size, r, ny, nx) in enumerate(grids):
                a, b = shards[g][k]
                if a == b:
                    continue
                lo, hi = max(a - 1, 0), min(b + 1, ny)
                orig = orig_dev[lo * size:hi * size].to(dev)
                bits0 = me_ssd._bits0_dev(r, dev)
                # HEVC_TPU_ME_LOCAL_ONLY as the whole frame's search sees it
                local_only = me_ssd._local_only(size, r, ny, nx)
                for i, refp in enumerate(refs):
                    rp = refp[lo * size:hi * size + 2 * pad].to(dev)
                    idx = me_ssd.me_idx_frame(
                        orig, rp, bits0, lam_q8, size=size, r=r, ny=hi - lo,
                        nx=nx, pad=pad, depth=depth, local_only=local_only)
                    pieces.append(idx[(a - lo) * nx:(b - lo) * nx])
                    where.append((i, g, a, b))
            if pieces:
                pending.append((runtime.Readback(torch.cat(pieces)), where))

    def collect():
        out = np.empty((len(refs), offs[-1]), np.int32)
        for readback, where in pending:
            flat, pos = readback.result(), 0
            for i, g, a, b in where:
                nx = grids[g][3]
                n = (b - a) * nx
                out[i, offs[g] + a * nx:offs[g] + b * nx] = flat[pos:pos + n]
                pos += n
        return out
    return collect


# ----------------------------------------------------------------------
# Frame axis: a batch of frames, one chunk a device
# ----------------------------------------------------------------------
def _as_u8(a: np.ndarray, what: str) -> np.ndarray:
    """8-bit samples as the search's uint8 planes (the reference runs this
    search at 8 bits)."""
    a = np.asarray(a)
    if a.size and (a.min() < 0 or a.max() > 255):
        raise ValueError(f"{what}: samples outside 0..255 (the frame-axis "
                         "search runs on 8-bit samples)")
    return np.ascontiguousarray(a, np.uint8)


def me_grids_frames(origs: np.ndarray, refs_padded: np.ndarray, *,
                    size: int, search_range: int, lam_fp: int,
                    mesh: Optional[Mesh] = None, axis_name: str = "frame",
                    device="cuda"):
    """Integer full-search MV grids for a batch of frames, split over
    `mesh` along the frame axis when given (else all on `device`).

    origs [F, H, W] 8-bit samples; refs_padded [F, H+2*PAD, W+2*PAD].
    The frame count is padded to a multiple of the mesh size by repeating
    the last frame, and device k searches chunk k. Returns (gx, gy) int32
    arrays [F, ny, nx]: the values encoder.native_frame.batched_me_grid
    gives per frame. `axis_name` names the mesh axis, as the reference's
    signature does; a Mesh carries one axis."""
    f, h, w = origs.shape
    r = search_range
    ny, nx = me_ssd._grid_dims(h, w, size)
    if ny == 0 or nx == 0:
        return (np.zeros((f, 0, 0), np.int32),) * 2
    origs = _as_u8(origs, "me_grids_frames origs")
    refs_padded = _as_u8(refs_padded, "me_grids_frames refs_padded")
    devices = (mesh.devices if mesh is not None
               else (runtime.resolve_device(device),))
    chunk = -(-f // len(devices))
    lam_q8 = me_ssd.lam_q8_of(lam_fp)
    pending = []
    for k, dev in enumerate(devices):
        # the padded frames repeat the last one, as the reference pads
        sel = [min(t, f - 1) for t in range(k * chunk, (k + 1) * chunk)]
        with _on(dev):
            o = runtime.upload(origs[sel], dev)
            rp = runtime.upload(refs_padded[sel], dev)
            bits0 = me_ssd._bits0_dev(r, dev)
            idx = torch.stack([me_ssd.me_idx_frame(
                o[i], rp[i], bits0, lam_q8, size=size, r=r, ny=ny, nx=nx,
                pad=PAD) for i in range(chunk)])
            pending.append(runtime.Readback(idx))
    idx = np.concatenate([p.result() for p in pending])[:f]
    nyx = 2 * r + 1
    gy = (idx // nyx - r).astype(np.int32).reshape(f, ny, nx)
    gx = (idx % nyx - r).astype(np.int32).reshape(f, ny, nx)
    return gx, gy


def me_grid_spatial(orig: np.ndarray, ref_padded: np.ndarray, *, size: int,
                    search_range: int, lam_fp: int, mesh: Mesh,
                    axis_name: str = "frame"):
    """One frame's MV grid with its block rows split over the mesh
    (me_idx_blocks_async); the planes are uploaded to the mesh's first
    device. Returns (gx, gy) int32 [ny, nx]."""
    h, w = orig.shape
    r = search_range
    ny, nx = me_ssd._grid_dims(h, w, size)
    dev = mesh.devices[0]
    o = runtime.upload(_as_u8(orig, "me_grid_spatial orig"), dev)
    rp = runtime.upload(_as_u8(ref_padded, "me_grid_spatial ref_padded"),
                        dev)
    idx = me_idx_blocks_async(o, [rp], [(size, r, ny, nx)],
                              me_ssd.lam_q8_of(lam_fp), mesh=mesh,
                              pad=PAD)()[0]
    return me_ssd._grids(idx, r, ny, nx)


# ----------------------------------------------------------------------
# Mesh-parallel clip encode
# ----------------------------------------------------------------------
def encode_clip(cfg, frames: List[List[np.ndarray]],
                mesh: Optional[Mesh] = None, lookahead: bool = False,
                device=None) -> Tuple[bytes, list]:
    """Encode a clip over a device mesh.

    The default mode is the product path, ``EncoderTop(cfg, mesh=mesh)``:
    every motion search of the encode splits its block rows over the mesh
    and gives the unsharded grids, for every GOP shape. As in the
    reference, an encode under a mesh computes no fractional-refine tables
    and runs no one-frame lookahead, so its stream equals the unsharded
    encode's with HEVC_TPU_ME_PREFETCH=0.

    ``lookahead=True`` instead batches the whole clip's integer search
    against the *original* previous picture into one frame-axis call
    (me_grids_frames) and feeds it to the encoder through its me_provider:
    the stream stays conformant but differs from the product stream.
    Low-delay GOPs only.

    The encoder runs on the mesh's first device (or `device` without a
    mesh, the card by default); asking for another raises. Returns
    (annexb_bytes, per-frame stats list)."""
    from ..encoder.top import EncoderTop

    if mesh is not None:
        dev = mesh.devices[0]
        if device is not None and not _same_device(device, dev):
            raise ValueError(f"encode_clip: device {device!r} is not the "
                             f"mesh's first device {dev}")
    else:
        dev = runtime.resolve_device("cuda" if device is None else device)

    if not lookahead:
        enc = EncoderTop(cfg, mesh=mesh, device=dev)
        out = b"".join(enc.encode_frame(f) for f in frames)
        out += enc.flush()
        return out, enc.stats

    enc = EncoderTop(cfg, device=dev)
    if enc.reordered:
        raise ValueError("lookahead mesh encode supports low-delay GOPs "
                         "only; use the default (product-path) mode for "
                         "random access")
    size = enc.sps.ctu_size >> 1
    r = cfg.search_range
    lam = 0.4624 * (2.0 ** ((cfg.qp - 12) / 3.0))
    lam_fp = int(65536.0 * math.sqrt(lam))
    ip = cfg.intra_period
    inter = [t for t in range(len(frames))
             if not (t == 0 or (ip > 0 and t % max(ip, 1) == 0))]
    grids = {}
    if inter:
        origs = np.stack([frames[t][0] for t in inter])
        refs = np.stack([pad_plane(np.asarray(frames[t - 1][0], np.int16),
                                   PAD) for t in inter])
        gx, gy = me_grids_frames(origs, refs, size=size, search_range=r,
                                 lam_fp=lam_fp, mesh=mesh, device=dev)
        for i, t in enumerate(inter):
            grids[t] = (gx[i], gy[i])

    enc.me_provider = lambda poc, *_a: grids.get(poc)
    out = b"".join(enc.encode_frame(f) for f in frames)
    out += enc.flush()
    return out, enc.stats
