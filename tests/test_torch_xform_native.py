"""The host CU engine's core transform pair (entropy/native/dsp.cpp
fwd_xform, inv_xform: one instance per block size), through its test-only
entry hevc_dsp_xform, equal to ops/transform.py's numpy twins on every
size, the 4-point DST, bit depths 8, 10 and 12 (the standard library) and
16 (the high-bit-depth one): random blocks and extremes. The forward takes
residuals up to +-(2^bd - 1); the inverse takes coefficients up to
+-32768, with signs chosen so that the stage-1 output leaves 16 bits and
is clipped; the result's clip to the 16-bit sample type engages where the
size and depth reach it (10 bits: 32x32; 12 bits: 8x8 and above)."""
import numpy as np
import pytest

from hevc_tpu_torch.core import tables
from hevc_tpu_torch.entropy.cabac import get_lib
from hevc_tpu_torch.ops.transform import (forward_transform_np,
                                          inverse_transform_np)
from test_torch_helpers import one_torch_thread  # noqa: F401

KINDS = [(4, True), (4, False), (8, False), (16, False), (32, False)]
RANDOM_BLOCKS = 64


def _native(lib, direction, n, bd, dst, block):
    out = np.empty((n, n), np.int32)
    lib.hevc_dsp_xform(direction, n, bd, int(dst),
                       np.ascontiguousarray(block, np.int32), out)
    return out


def _forward_blocks(rng, n, bd):
    lim = (1 << bd) - 1
    blocks = [rng.integers(-lim, lim + 1, (n, n)) for _ in range(RANDOM_BLOCKS)]
    blocks += [np.full((n, n), lim), np.full((n, n), -lim)]
    blocks += [np.where(rng.integers(0, 2, (n, n)) == 1, lim, -lim)
               for _ in range(8)]
    # the checkerboard and the stripes: every energy in one frequency
    i, j = np.indices((n, n))
    blocks += [np.where((i + j) % 2 == 0, lim, -lim),
               np.where(j % 2 == 0, lim, -lim),
               np.where(i < n // 2, lim, -lim)]
    return blocks


def _inverse_blocks(rng, n, dst):
    t = tables.DST4 if dst else tables.dct_matrix(n)
    sign = np.where(t >= 0, 1, -1)
    blocks = [rng.integers(-32768, 32768, (n, n))
              for _ in range(RANDOM_BLOCKS)]
    blocks += [np.full((n, n), 32767), np.full((n, n), -32768)]
    # +-32768 with the signs of the basis at sample (i, j) in both
    # directions: stage 1 leaves the 16-bit range in row i, and stage 2
    # gathers the clipped row at (i, j)
    for i in range(n):
        j = int(rng.integers(n))
        block = 32768 * np.outer(sign[:, i], sign[:, j])
        blocks += [block, -block]
    return blocks


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("bd", [8, 10, 12, 16])
@pytest.mark.parametrize("n,dst", KINDS,
                         ids=["dst4", "dct4", "dct8", "dct16", "dct32"])
def test_native_xform_equals_numpy(n, dst, bd, direction):
    lib = get_lib(bd > 14)
    rng = np.random.default_rng(1000 * n + 10 * bd + dst
                                + (direction == "inverse"))
    if direction == "forward":
        for block in _forward_blocks(rng, n, bd):
            np.testing.assert_array_equal(
                _native(lib, 0, n, bd, dst, block),
                forward_transform_np(block, n, bd, dst))
        return
    t = (tables.DST4 if dst else tables.dct_matrix(n)).astype(np.int64)
    clipped = 0
    for block in _inverse_blocks(rng, n, dst):
        stage1 = (t.T @ block + 64) >> 7
        clipped += int(np.abs(stage1).max() > 32767)
        np.testing.assert_array_equal(
            _native(lib, 1, n, bd, dst, block),
            inverse_transform_np(block, n, bd, dst))
    assert clipped > 0
