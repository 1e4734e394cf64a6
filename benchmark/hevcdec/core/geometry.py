"""CTU/CU/TU geometry: z-scan (Morton) addressing and availability.

Parity: reference TComDataCU neighbor derivation (getPULeft/getPUAbove,
TComDataCU.cpp) and TComRom's g_auiZscanToRaster/g_auiRasterToZscan tables —
replaced by computed Morton interleaving (no tables), and the 1,099-case
`getIndexBlock` switch (TComDataCU.cpp:3379) is replaced by the computed
`ctu_part_index` in hevc_tpu_torch.core.partitions.
"""
from __future__ import annotations

import numpy as np


def _part1by1(v: int) -> int:
    v &= 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def zscan(bx: int, by: int) -> int:
    """Morton z-scan address of the min-block at column bx, row by."""
    return _part1by1(bx) | (_part1by1(by) << 1)


def raster_to_zscan_table(blocks_per_row: int) -> np.ndarray:
    """z-addr for each raster min-block position in a square CTU."""
    out = np.empty(blocks_per_row * blocks_per_row, dtype=np.int32)
    for by in range(blocks_per_row):
        for bx in range(blocks_per_row):
            out[by * blocks_per_row + bx] = zscan(bx, by)
    return out


class AvailabilityMap:
    """Sample availability for intra prediction (spec 6.4.1 z-scan rule).

    A neighbouring sample is available iff it lies inside the picture and its
    containing min-block precedes the current block in coding order: CTU
    raster order first, z-scan order within the CTU. Single-slice,
    single-tile assumption (multi-slice/tile adds boundary predicates here).
    """

    def __init__(self, pic_w: int, pic_h: int, ctu_size: int = 64,
                 min_block: int = 4, tile_cols: int = 0, tile_rows: int = 0,
                 slice_start_ctu: int = 0):
        self.pic_w = pic_w
        self.pic_h = pic_h
        self.ctu_size = ctu_size
        self.min_block = min_block
        self.ctus_w = -(-pic_w // ctu_size)
        self.ctus_h = -(-pic_h // ctu_size)
        # first CTU (scan order) of the current slice segment: samples in
        # earlier slices are unavailable for prediction (spec 6.4.1)
        self.slice_start_ctu = slice_start_ctu
        self.tiles = tile_cols > 1 or tile_rows > 1
        if self.tiles:
            tc, tr = max(tile_cols, 1), max(tile_rows, 1)
            self._xedges = [i * self.ctus_w // tc for i in range(tc)] \
                + [self.ctus_w]
            self._yedges = [i * self.ctus_h // tr for i in range(tr)] \
                + [self.ctus_h]
            # tile-scan rank of every CTU (spec 6.5.1)
            self._rank = {}
            r = 0
            for ty in range(tr):
                for tx in range(tc):
                    for cy in range(self._yedges[ty], self._yedges[ty + 1]):
                        for cx in range(self._xedges[tx],
                                        self._xedges[tx + 1]):
                            self._rank[(cx, cy)] = r
                            r += 1

    def tile_id(self, cx: int, cy: int) -> int:
        col = sum(1 for e in self._xedges[1:-1] if cx >= e)
        row = sum(1 for e in self._yedges[1:-1] if cy >= e)
        return row * (len(self._xedges) - 1) + col

    def block_order_key(self, x: int, y: int) -> int:
        """Total coding-order key of the min-block containing sample (x,y)."""
        cx, cy = x // self.ctu_size, y // self.ctu_size
        if self.tiles:
            ctu_addr = self._rank[(cx, cy)]
        else:
            ctu_addr = cy * self.ctus_w + cx
        bx = (x % self.ctu_size) // self.min_block
        by = (y % self.ctu_size) // self.min_block
        return (ctu_addr << 16) | zscan(bx, by)

    def is_available(self, x: int, y: int, cur_x0: int, cur_y0: int) -> bool:
        """Is sample (x,y) available as predictor for block at (cur_x0,cur_y0)?"""
        if x < 0 or y < 0 or x >= self.pic_w or y >= self.pic_h:
            return False
        if self.tiles and self.tile_id(x // self.ctu_size,
                                       y // self.ctu_size) != self.tile_id(
                cur_x0 // self.ctu_size, cur_y0 // self.ctu_size):
            return False  # prediction never crosses a tile boundary
        if self.slice_start_ctu and (self.block_order_key(x, y) >> 16) \
                < self.slice_start_ctu:
            return False  # sample belongs to an earlier slice segment
        return self.block_order_key(x, y) < self.block_order_key(cur_x0, cur_y0)
