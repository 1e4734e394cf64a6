"""Whole-frame batched intra mode prescreen on the device.

Counterpart of hevc_tpu/ops/intra_screen.py. Reference
TEncSearch::estIntraPredLumaQT (TEncSearch.cpp:2184) builds a per-PU
candidate mode list by Hadamard SATD over all 35 modes before the expensive
RD loop. Every aligned block of one size forms a batch; reference vectors
come from ORIGINAL pixels, so the blocks are independent and the frame's
35-mode predict + SATD runs on the device. The native engine consumes the
top-k candidate modes per block (engine.cpp intra_try_list).

k follows the reference's g_aucIntraModeNumFast (TComRom.cpp:60): 8
candidates for 8x8, 3 for 16x16/32x32; 4x4 blocks give costs only.

Out-of-frame reference rows/cols take the mid-level value (the spec's
no-reference substitution, 8.4.4.2.2, approximated); the final mode choice
is re-ranked against true recon references in the engine.

On a card, `intra_screen` launches the hand-written kernel
csrc/intra_screen.cu once per block size, computing every address from the
block position. Its plain version, `intra_screen_plain`, is the torch
tensor ops of `_screen_chunk` (ops.intra.predict_all_modes +
ops.satd.satd_batch) over static gather tables (`_frame_plan`); it runs
for CPU tensors only.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import runtime
from .intra import predict_all_modes
from .satd import satd_batch

K_OF_LOG2 = {2: 0, 3: 8, 4: 3, 5: 3}
_CHUNK = 16384  # blocks per batch (bounds the [B, 35, N, N] buffers)


@functools.lru_cache(maxsize=None)
def _index_maps(n: int, ny: int, nx: int, w: int, h: int):
    """Static gather maps into the padded plane P (shape [h+1, w+1],
    P[y+1, x+1] = orig[y, x]; P[0, :] and P[:, 0] hold mid-level).

    Returns (f_idx [B, 4n+1], blk_idx [B, n*n]) int32 flat indices.
    f layout (ops.intra docstring): f[2n]=corner p[-1][-1],
    f[2n+1+x]=top p[x][-1], f[2n-1-y]=left p[-1][y]."""
    b = ny * nx
    y0 = (np.arange(ny, dtype=np.int64)[:, None] * n)
    x0 = (np.arange(nx, dtype=np.int64)[None, :] * n)
    y0 = np.broadcast_to(y0, (ny, nx)).reshape(b)
    x0 = np.broadcast_to(x0, (ny, nx)).reshape(b)
    stride = w + 1
    f_rows = np.empty((b, 4 * n + 1), np.int64)
    f_cols = np.empty((b, 4 * n + 1), np.int64)
    f_rows[:, 2 * n] = y0
    f_cols[:, 2 * n] = x0
    xs = np.arange(2 * n, dtype=np.int64)
    # top row p[x][-1] = P[y0, x0+1+x] (clamped to the last column)
    f_rows[:, 2 * n + 1:] = y0[:, None]
    f_cols[:, 2 * n + 1:] = np.minimum(x0[:, None] + 1 + xs[None, :], w)
    # left col p[-1][y] = P[y0+1+y, x0] (clamped to the last row)
    f_rows[:, 2 * n - 1::-1] = np.minimum(y0[:, None] + 1 + xs[None, :], h)
    f_cols[:, 2 * n - 1::-1] = x0[:, None]
    f_idx = (f_rows * stride + f_cols).astype(np.int32)
    ij = np.arange(n, dtype=np.int64)
    blk = ((y0[:, None, None] + 1 + ij[None, :, None]) * stride
           + x0[:, None, None] + 1 + ij[None, None, :])
    return f_idx, blk.reshape(b, n * n).astype(np.int32)


def _mode_bits_est(mode: int) -> int:
    """Engine mode_bits with the typical MPM trio {planar, DC, vertical}
    (engine.cpp mode_bits: MPM0 2 bits, MPM1/2 3, else 6)."""
    if mode == 0:
        return 2
    if mode in (1, 26):
        return 3
    return 6


def _screen_chunk(p_flat, fi, bi, lam_tab, *, size, bit_depth, k):
    """One chunk's top-k candidate modes (uint8 [B, k]) and per-block best
    cost (int32 [B]); k == 0 returns costs only. p_flat: the padded plane,
    flattened, int32; fi [B, 4n+1] / bi [B, n*n]: flat gather indices."""
    n = size
    b = fi.shape[0]
    f = p_flat.index_select(0, fi.reshape(-1)).reshape(b, 4 * n + 1)
    # [1 2 1]/4 smoothing, ends copied (spec 8.4.4.2.3; strong smoothing
    # is not modelled in the screen)
    ff = torch.cat([f[:, :1],
                    (f[:, :-2] + 2 * f[:, 1:-1] + f[:, 2:] + 2) >> 2,
                    f[:, -1:]], dim=1)
    preds = predict_all_modes(f, ff, size=n, bit_depth=bit_depth,
                              is_luma=True)                  # [B, 35, n, n]
    blocks = p_flat.index_select(0, bi.reshape(-1)).reshape(b, 1, n, n)
    satd = satd_batch(preds, blocks, size=n)                 # [B, 35]
    cost = satd + lam_tab[None, :]
    best = cost.min(dim=1).values.to(torch.int32)
    if k == 0:
        return None, best
    # lax.top_k(-cost, k) order: cheapest first, equal costs lowest mode
    # first. torch.topk promises no order among ties, so rank a packed
    # cost * 64 + mode key, which has none.
    modes = torch.arange(35, dtype=torch.int64, device=cost.device)
    key = cost.to(torch.int64) * 64 + modes[None, :]
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return (top & 63).to(torch.uint8), best


def _sizes(w: int, h: int, log2s: tuple):
    """(log2, n, ny, nx, k, b) of every block size that fits the frame, in
    the order of the packed outputs."""
    out = []
    for log2 in log2s:
        n = 1 << log2
        ny, nx = h // n, w // n
        if ny and nx:
            out.append((log2, n, ny, nx, K_OF_LOG2[log2], ny * nx))
    return out


@functools.lru_cache(maxsize=16)
def _frame_plan(w: int, h: int, log2s: tuple, device: torch.device):
    """The plain version's gather tables for every (size, chunk), uploaded
    once per process, resolution and device."""
    plan = []
    for (log2, n, ny, nx, k, b) in _sizes(w, h, log2s):
        f_idx, blk_idx = _index_maps(n, ny, nx, w, h)
        chunks = []
        for s in range(0, b, _CHUNK):
            e = min(s + _CHUNK, b)
            chunks.append((runtime.upload(f_idx[s:e].astype(np.int64),
                                          device),
                           runtime.upload(blk_idx[s:e].astype(np.int64),
                                          device)))
        plan.append((n, k, chunks))
    return plan


def intra_screen_plain(plane: torch.Tensor, lam_tab: torch.Tensor, *,
                       bit_depth: int, log2s=(2, 3, 4, 5)):
    """Plain version of `intra_screen`: `_screen_chunk` over the gather
    tables of `_frame_plan`, chunk by chunk."""
    h, w = plane.shape[0] - 1, plane.shape[1] - 1
    p_flat = plane.reshape(-1).to(torch.int32)
    cands, costs = [], []
    for (n, k, chunks) in _frame_plan(w, h, tuple(log2s), plane.device):
        for (fi, bi) in chunks:
            idx, cost = _screen_chunk(p_flat, fi, bi, lam_tab, size=n,
                                      bit_depth=bit_depth, k=k)
            if idx is not None:
                cands.append(idx.reshape(-1))
            costs.append(cost)
    return (torch.cat(cands) if cands else
            torch.zeros(0, dtype=torch.uint8, device=plane.device),
            torch.cat(costs))


def intra_screen(plane: torch.Tensor, lam_tab: torch.Tensor, *,
                 bit_depth: int, log2s=(2, 3, 4, 5)):
    """The prescreen of every aligned block of sizes 1 << log2s.

    plane: the padded plane [h+1, w+1] (P[y+1, x+1] = orig[y, x]; row 0
    and column 0 hold 1 << (bit_depth-1)), int16 at 8-14 bits and int32 at
    15-16 bits; lam_tab: int32 [35], the mode cost added to each SATD.
    Returns the packed (cands uint8 [sum b*k], costs int32 [sum b]), size
    by size in the order of log2s, block-row major. On a card one kernel
    launch per size (the int32 instance for an int32 plane); CPU tensors
    take `intra_screen_plain`."""
    if plane.device.type == "cpu":
        return intra_screen_plain(plane, lam_tab, bit_depth=bit_depth,
                                  log2s=log2s)
    wide = bit_depth > 14
    runtime.require(plane, torch.int32 if wide else torch.int16,
                    "intra_screen plane")
    runtime.require(lam_tab, torch.int32, "intra_screen lam_tab")
    if not 8 <= bit_depth <= 16 or lam_tab.numel() != 35:
        raise ValueError("intra_screen: bit depth 8-16 and 35 mode costs")
    h, w = plane.shape[0] - 1, plane.shape[1] - 1
    sizes = _sizes(w, h, tuple(log2s))
    dev = plane.device
    cands = torch.empty(sum(b * k for (*_, k, b) in sizes),
                        dtype=torch.uint8, device=dev)
    costs = torch.empty(sum(b for (*_, b) in sizes), dtype=torch.int32,
                        device=dev)
    lib = runtime.kernel_lib("intra_screen")
    stream = runtime.stream_of(plane)
    offi = offc = 0
    for (log2, n, ny, nx, k, b) in sizes:
        rc = (lib.hevc_intra_screen32 if wide else lib.hevc_intra_screen)(
            plane.data_ptr(), plane.stride(0), h, w, lam_tab.data_ptr(),
            bit_depth, n, ny, nx, k, cands.data_ptr() + offi,
            costs.data_ptr() + 4 * offc, stream)
        runtime.check(lib, rc, "intra_screen")
        offi += b * k
        offc += b
    return cands, costs


def screen_frame_async(orig_y: np.ndarray, bit_depth: int, sqrt_lam: float,
                       log2s=(2, 3, 4, 5), device="cuda"):
    """Launch the prescreen on the device and return a zero-arg resolver.

    The work runs asynchronously on the device; only the resolver blocks
    (on one packed readback of the candidates and one of the costs).
    Callers with a frame of host work between launch and use hide the
    device time behind it.

    Returns {log2: (cands uint8 [ny, nx, k], costs int64 [ny, nx])};
    costs are the best original-reference SATD+mode-bits per block, the
    engine's TU/CU split-gate signal (engine.cpp code_r gate)."""
    dev = runtime.resolve_device(device)
    if not 8 <= bit_depth <= 16:
        raise ValueError(f"screen_frame: {bit_depth}-bit samples (8-16)")
    h, w = orig_y.shape
    mid = 1 << (bit_depth - 1)
    # 15-16-bit samples exceed int16 (the engine's HBD build carries them
    # as int32); the SATD arithmetic is int32-safe at every depth
    p = np.empty((h + 1, w + 1), np.int16 if bit_depth <= 14 else np.int32)
    p[1:, 1:] = orig_y
    p[0, :] = mid
    p[:, 0] = mid
    lam_tab = runtime.upload(np.array(
        [round(sqrt_lam * _mode_bits_est(m)) for m in range(35)], np.int32),
        dev)
    cands, costs = intra_screen(runtime.upload(p, dev), lam_tab,
                                bit_depth=bit_depth, log2s=log2s)
    packed_idx = runtime.Readback(cands)
    packed_cost = runtime.Readback(costs)
    sizes = _sizes(w, h, tuple(log2s))

    def resolve():
        flat_i = packed_idx.result()
        flat_c = packed_cost.result()
        out = {}
        offi = offc = 0
        for (log2, n, ny, nx, k, b) in sizes:
            out[log2] = (flat_i[offi:offi + b * k].reshape(ny, nx, k)
                         .astype(np.uint8),
                         flat_c[offc:offc + b].astype(np.int64)
                         .reshape(ny, nx))
            offi += b * k
            offc += b
        return out

    return resolve


def screen_frame(orig_y: np.ndarray, bit_depth: int, sqrt_lam: float,
                 log2s=(2, 3, 4, 5), device="cuda"):
    """Device intra prescreen for every aligned block of sizes 1<<log2s.

    Returns {log2: (cands uint8 [ny, nx, k], costs int64 [ny, nx])} for
    NativeCtuEngine.set_intra_hints."""
    return screen_frame_async(orig_y, bit_depth, sqrt_lam, log2s, device)()
