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
from test_torch_helpers import one_torch_thread  # noqa: F401


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


@pytest.mark.parametrize("kind", ["random", "zeros", "full"])
@pytest.mark.parametrize("size,h,w", [(8, 8, 8), (16, 47, 301), (32, 200, 133),
                                      (32, 1216, 2048), (8, 38, 250),
                                      (16, 41, 129), (32, 79, 260),
                                      (32, 33, 35), (16, 1104, 1952)])
def test_box_plane_matches_reference_at_card_shapes(size, h, w, kind):
    """The whole box plane at the card tests' shapes (no multiple of the
    kernel's 16-row band or its column strip, a view that starts at an odd
    column), held to the reference's integral image: its squares are
    zero-padded to a square plane whose single block window (ny = nx = 1,
    2r + 1 offsets a side) covers every box position."""
    big = _plane(kind, h + 5, w + 9, seed=h + w)
    roi = big[3:3 + h, 7:7 + w]
    box = me_ssd.box_energies(torch.from_numpy(roi), size).numpy()
    oh, ow = h - size + 1, w - size + 1
    assert box.shape == (oh, ow)
    side = max(oh, ow) | 1
    r = side // 2
    p2 = np.zeros((side + size - 1, side + size - 1), np.int32)
    p2[:h, :w] = (roi.astype(np.int32) - 128) ** 2
    with no_jax_cache_writes():
        exp = np.asarray(me_mxu._window_energies(jnp.asarray(p2), size=size,
                                                 r=r, ny=1, nx=1))[0]
    np.testing.assert_array_equal(box, exp[:oh, :ow])
