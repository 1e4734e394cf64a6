"""The fractional-refine tables at 15 and 16 bits (int32 planes): the plain
versions of hevc_tpu_torch's refine_tables against hevc_tpu's device
program (me_mxu._build_phases, _satd_of_tiles and
_me_idx_multi2_jit(refine=True)), exactly, on the CPU, with patches of 0,
2^15 and 2^16 - 1 (2^14 for 2^15 at 15 bits); and 16-bit low-delay B
encodes with HEVC_TPU_ME_REFINE=1, byte-identical to hevc_tpu's through
its HBD build and decoded with every MD5 SEI "OK"."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.cli.encode import main as jax_main
from hevc_tpu.encoder import native_frame as jax_native_frame
from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.cli.encode import main as port_main
from hevc_tpu_torch.decoder.top import DecoderTop
from hevc_tpu_torch.entropy.cabac import _with_slack
from hevc_tpu_torch.ops import me_ssd
from test_torch_hbd import _clip16
from test_torch_helpers import (CFG_DIR, no_jax_cache_writes,
                                one_torch_thread,  # noqa: F401
                                private_reference_native)  # noqa: F401
from test_torch_me_refine import _jax_tables, _planes, _port_tables


def _patched(a, depth, origin):
    """a with 12x12 patches of 0, 2^(depth-1) and 2^depth - 1 (at 16 bits
    0, 2^15 and 2^16 - 1) every 20 samples from `origin` (the patches move
    between orig and reference)."""
    a = a.copy()
    vals = (0, 1 << (depth - 1), (1 << depth) - 1)
    for i, y0 in enumerate(range(origin, a.shape[0] - 12, 20)):
        for j, x0 in enumerate(range(origin, a.shape[1] - 12, 20)):
            a[y0:y0 + 12, x0:x0 + 12] = vals[(i + j) % 3]
    return a


@pytest.mark.parametrize("kind", ["texture", "extremes"])
@pytest.mark.parametrize("depth,r", [(15, 8), (16, 8), (15, 78), (16, 78)])
def test_refine_tables_hbd_equal_reference(depth, r, kind):
    """Both grids' indices and tables on int32 planes equal hevc_tpu's; at
    r = 78 the tile starts leave the phase planes (the WIDE layout)."""
    orig, refp = _planes(depth)
    assert orig.dtype == refp.dtype == np.int32
    if kind == "extremes":
        orig = _patched(orig, depth, 2)
        refp = _patched(refp, depth, 85)
    ref = _jax_tables(orig, refp, r, depth)
    got = _port_tables(orig, refp, r, depth)
    for name, a, b in zip(("i1", "i2", "off1", "half1", "off2", "half2"),
                          got, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(np.unique(np.r_[got[2], got[4]])) >= 4  # many offsets


@pytest.mark.parametrize("depth", [15, 16])
def test_phases_and_satd_hbd_equal_reference(depth):
    """The phase planes and tile SATDs at 15 and 16 bits, where the
    vertical sums over the horizontal intermediates and the tile sums of
    |coefficient| pass 2^24: random samples and the extreme patches (the
    planes' maximum against zeros)."""
    rng = np.random.default_rng(depth)
    top = 1 << depth
    refp = _patched(rng.integers(0, top, (56, 72)).astype(np.int32), depth,
                    3)
    got = me_ssd._build_phases_plain(torch.from_numpy(refp), depth)
    with no_jax_cache_writes():
        ref = np.asarray(me_mxu._build_phases(jnp.asarray(refp), depth))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.max() == top - 1 and got.min() == 0
    for size in (4, 8, 16, 32):
        ob, tiles = rng.integers(0, top, (2, 5, size, size)).astype(np.int32)
        ob[0], tiles[0] = top - 1, 0          # the largest SATD there is
        ob[1, ::2], tiles[1, 1::2] = 0, top - 1
        with no_jax_cache_writes():
            ref = np.asarray(me_mxu._satd_of_tiles(jnp.asarray(ob),
                                                   jnp.asarray(tiles), size))
        got = me_ssd._satd_of_tiles_plain(torch.from_numpy(ob),
                                          torch.from_numpy(tiles), size)
        np.testing.assert_array_equal(got, ref)


W, H, N = 192, 128, 5


class _RefEngineWithSlack(jax_native_frame.NativeCtuEngine):
    """hevc_tpu's engine given the port's zeroed rows after its luma plane
    (entropy/cabac.py _with_slack): both engines screen a 12-sample side
    of an AMP unit in 8x8 tiles and read up to 4 rows past the picture's
    bottom-right corner, which without the slack is whatever memory
    follows the plane (ROADMAP.md section 3)."""

    def __init__(self, params, ep, senc, orig, *args, **kwargs):
        super().__init__(params, ep, senc,
                         [_with_slack(orig[0])] + list(orig[1:]), *args,
                         **kwargs)


def test_16bit_refine_encode_stream_identical(monkeypatch, tmp_path):
    """A 16-bit low-delay B encode (Main-RExt cfg) with
    HEVC_TPU_ME_REFINE=1 and HEVC_TPU_ME_PREFETCH=0 in both packages: the
    port computes the tables on int32 planes for every B picture and the
    engine takes their decisions; hevc_tpu runs its host refinement on
    JAX-CPU. Same bytes, same recon, every hash "OK". This content reaches
    the read past the luma plane: hevc_tpu's engine gets the port's slack
    (_RefEngineWithSlack), without which its stream changes from run to
    run."""
    monkeypatch.setenv("HEVC_TPU_ME_REFINE", "1")
    monkeypatch.setenv("HEVC_TPU_ME_PREFETCH", "0")
    monkeypatch.setattr(jax_native_frame, "NativeCtuEngine",
                        _RefEngineWithSlack)
    calls = []
    real = me_ssd.refine_tables

    def spy(orig, refp, gidx, **k):
        calls.append((refp.dtype, k["depth"], k["size"]))
        return real(orig, refp, gidx, **k)
    monkeypatch.setattr(me_ssd, "refine_tables", spy)
    clip = tmp_path / "in16.yuv"
    _clip16(clip, W, H, N, "420")
    args = ["-c", os.path.join(CFG_DIR, "encoder_lowdelay_main_rext.cfg"),
            "-i", str(clip), "-wdt", str(W), "-hgt", str(H), "-f", str(N),
            "-fr", "30", "-q", "32", "--InputBitDepth=16",
            "--InternalBitDepth=16", "--Profile=main-RExt"]
    streams = []
    for tag, run in (("ref", jax_main),
                     ("port", lambda a: port_main(a, device="cpu"))):
        bs = tmp_path / f"{tag}.bin"
        with no_jax_cache_writes():
            run(args + ["-b", str(bs), "-o", str(tmp_path / f"{tag}.yuv")])
        streams.append(bs.read_bytes())
    ref, got = streams
    assert len(got) > 0 and got == ref
    assert (tmp_path / "port.yuv").read_bytes() == \
        (tmp_path / "ref.yuv").read_bytes()
    assert set(calls) == {(torch.int32, 16, 32), (torch.int32, 16, 16)}
    assert len(calls) >= 2 * (N - 1)
    dec = DecoderTop()
    assert sum(1 for _ in dec.decode_stream(got)) == N
    assert dec.hash_status == ["OK"] * N
