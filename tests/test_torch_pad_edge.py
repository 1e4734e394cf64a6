"""The reference padding of the device motion search: the port's
pad_ref_device (one F.pad(mode="replicate")) against hevc_tpu's
me_mxu.pad_ref_device (jnp.pad mode="edge") on JAX-CPU, on the uint8,
int16 and int32 planes that me_dtype gives 8-, 9-14- and 16-bit samples,
a pad wider than the plane included. Exact equality."""
import jax
import numpy as np
import pytest
import torch

from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.ops import me_ssd
from test_torch_helpers import no_jax_cache_writes
from test_torch_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("h,w,pad", [(24, 40, 8), (7, 5, 80), (1, 3, 2)])
@pytest.mark.parametrize("dtype,top", [(np.uint8, 255), (np.int16, 16383),
                                       (np.int32, 65535)])
def test_pad_ref_device_matches_jax(dtype, top, h, w, pad):
    rng = np.random.default_rng(h * w + pad)
    plane = rng.integers(0, top + 1, (h, w)).astype(dtype)
    with no_jax_cache_writes():
        exp = np.asarray(jax.device_get(me_mxu.pad_ref_device(plane, pad)))
    got = me_ssd.pad_ref_device(torch.from_numpy(plane), pad)
    assert got.dtype == torch.from_numpy(plane).dtype
    assert got.shape == exp.shape == (h + 2 * pad, w + 2 * pad)
    np.testing.assert_array_equal(got.numpy(), exp)
