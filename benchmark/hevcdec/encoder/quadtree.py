"""Shared CU/TU quadtree walkers.

These mirror the native syntax walker (entropy/native/syntax.cpp cu_tree /
transform_tree) exactly, so the Python planner/recon and the C++ syntax
writer agree on the effective tree for any decision maps (including
picture-boundary implicit splits). Parity: reference TEncCu::xCompressCU
recursion structure (TEncCu.cpp:357).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def cu_leaves(depth_map: np.ndarray, ctu_x0: int, ctu_y0: int,
              pic_w: int, pic_h: int, ctu_log2: int = 6,
              min_cb_log2: int = 3) -> List[Tuple[int, int, int]]:
    """Effective CU leaves [(x0, y0, log2)] in z-order for one CTU.
    depth_map: per-4x4 raster map (CTU-local) of target depths."""
    out = []

    def walk(x0, y0, log2, depth):
        if x0 >= pic_w or y0 >= pic_h:
            return
        size = 1 << log2
        boundary = (x0 + size > pic_w) or (y0 + size > pic_h)
        target = depth_map[(y0 - ctu_y0) >> 2, (x0 - ctu_x0) >> 2]
        split = (boundary or depth < target) and log2 > min_cb_log2
        if split:
            h = size >> 1
            walk(x0, y0, log2 - 1, depth + 1)
            walk(x0 + h, y0, log2 - 1, depth + 1)
            walk(x0, y0 + h, log2 - 1, depth + 1)
            walk(x0 + h, y0 + h, log2 - 1, depth + 1)
        else:
            out.append((x0, y0, log2))

    walk(ctu_x0, ctu_y0, ctu_log2, 0)
    return out


def tu_leaves(tu_depth_map: np.ndarray, cu_x0: int, cu_y0: int, cu_log2: int,
              ctu_x0: int, ctu_y0: int, intra_split: bool,
              max_tu_depth_intra: int = 3, min_tb_log2: int = 2,
              max_tb_log2: int = 5) -> List[Tuple[int, int, int, int, int]]:
    """Effective TU leaves [(x0, y0, log2, depth, blk_idx)] in z-order for a
    CU, mirroring the native transform_tree recursion."""
    out = []
    maxd = max_tu_depth_intra + (1 if intra_split else 0)

    def walk(x0, y0, log2, depth, blk):
        explicit = (log2 <= max_tb_log2 and log2 > min_tb_log2
                    and depth < maxd and not (intra_split and depth == 0))
        if log2 > max_tb_log2 or (intra_split and depth == 0):
            split = True
        elif explicit:
            split = (tu_depth_map[(y0 - ctu_y0) >> 2,
                                  (x0 - ctu_x0) >> 2] & 0x7) > depth
        else:
            split = False
        if split:
            h = 1 << (log2 - 1)
            walk(x0, y0, log2 - 1, depth + 1, 0)
            walk(x0 + h, y0, log2 - 1, depth + 1, 1)
            walk(x0, y0 + h, log2 - 1, depth + 1, 2)
            walk(x0 + h, y0 + h, log2 - 1, depth + 1, 3)
        else:
            out.append((x0, y0, log2, depth, blk))

    walk(cu_x0, cu_y0, cu_log2, 0, 0)
    return out
