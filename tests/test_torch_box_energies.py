"""hevc_tpu_torch.ops.me_ssd.box_energies (the window-energy plane the SSD
kernel reads; on the CPU its plain version) against hevc_tpu.ops.me_mxu's
_window_energies on JAX-CPU and a numpy brute force. Exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.ops import me_ssd
from test_torch_helpers import no_jax_cache_writes


def _plane(kind, h, w, seed):
    if kind == "zeros":
        return np.zeros((h, w), np.uint8)
    if kind == "full":
        return np.full((h, w), 255, np.uint8)
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(
        np.uint8)


@pytest.mark.parametrize("kind", ["random", "zeros", "full"])
@pytest.mark.parametrize("size,r,ny,nx", [(8, 2, 3, 4), (16, 5, 2, 3),
                                          (32, 16, 2, 2)])
def test_box_energies_match_window_energies(size, r, ny, nx, kind):
    aw = 2 * r + size
    roi = _plane(kind, (ny - 1) * size + aw, (nx - 1) * size + aw,
                 seed=size + r)
    box = me_ssd.box_energies(torch.from_numpy(roi), size)
    assert box.dtype == torch.int32
    assert box.shape == (roi.shape[0] - size + 1, roi.shape[1] - size + 1)
    c = roi.astype(np.int64) - 128
    sq = c * c
    brute = np.array([[sq[y:y + size, x:x + size].sum()
                       for x in range(box.shape[1])]
                      for y in range(box.shape[0])])
    np.testing.assert_array_equal(box.numpy(), brute)
    with no_jax_cache_writes():
        rc = jnp.asarray(roi, jnp.int32) - 128
        exp = np.asarray(me_mxu._window_energies(rc * rc, size=size, r=r,
                                                 ny=ny, nx=nx))
    nyx = 2 * r + 1
    rows = (np.arange(ny)[:, None] * size + np.arange(nyx)).reshape(-1)
    cols = (np.arange(nx)[:, None] * size + np.arange(nyx)).reshape(-1)
    got = (box.numpy()[rows][:, cols].reshape(ny, nyx, nx, nyx)
           .transpose(0, 2, 1, 3).reshape(ny * nx, nyx, nyx))
    np.testing.assert_array_equal(got, exp)
