"""16-bit video in hevc_tpu_torch: the high-bit-depth native build (int32
samples, `make hbd`), 16-bit encodes under the Main-RExt cfgs
byte-identical to hevc_tpu's HBD build on the CPU, every MD5 SEI checked
by the port's decoder, and the plain versions of the four kernels that
the 16-bit paths launch (ssd_table_deep, box_energies, the intra
prescreen and wp_apply_multi) on int32 planes of 15- and 16-bit samples,
equal to the reference's programs. The content is shifted left by 8 bits,
so that most samples exceed 2^15: an int16 treatment anywhere would wrap."""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_tpu.cli.encode import main as jax_main
from hevc_tpu.ops import intra_screen as jax_intra_screen
from hevc_tpu.ops import me_mxu
from hevc_tpu_torch.cli.encode import main as port_main
from hevc_tpu_torch.decoder.top import DecoderTop
from hevc_tpu_torch.entropy.cabac import get_lib
from hevc_tpu_torch.ops import intra_screen, me_ssd
from test_torch_helpers import (CFG_DIR, REPO, moving_frames,
                                no_jax_cache_writes,
                                private_reference_native)  # noqa: F401
from test_torch_helpers import one_torch_thread  # noqa: F401

PAD = 80


def test_hbd_library_carries_int32_samples():
    assert get_lib(True).hevc_pel_bits() == 32
    assert get_lib(False).hevc_pel_bits() == 16


def _clip16(path, w, h, n, chroma):
    """The reference's 16-bit conformance content: tools/make_test_yuv
    frames shifted left by 8 bits, 16-bit little-endian, in 4:2:0, 4:2:2
    or 4:4:4 (the 4:2:0 chroma repeated)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_test_yuv import make_frame
    with open(path, "wb") as fh:
        for t in range(n):
            y, u, v = (np.asarray(p) for p in make_frame(w, h, t))
            if chroma != "420":  # full vertical chroma resolution
                u = np.repeat(u, 2, axis=0)[:h, :]
                v = np.repeat(v, 2, axis=0)[:h, :]
            if chroma == "444":
                u = np.repeat(u, 2, axis=1)[:, :w]
                v = np.repeat(v, 2, axis=1)[:, :w]
            for p in (y, u, v):
                fh.write((p.astype(np.uint16) << 8).tobytes())


@pytest.mark.parametrize("cfg,label", [
    ("encoder_intra_main_rext.cfg", "intra"),
    ("encoder_lowdelay_main_rext.cfg", "ldb"),
    ("encoder_randomaccess_main_rext.cfg", "ra"),
    ("encoder_intra_main_rext.cfg", "intra422"),
    ("encoder_intra_main_rext.cfg", "intra444"),
])
def test_16bit_stream_identical(monkeypatch, tmp_path, cfg, label):
    """128x80, 3 frames, QP 32, --InternalBitDepth=16 --Profile=main-RExt
    (the reference's 16-bit conformance cases, and intra 4:4:4):
    byte-identical, every MD5 SEI "OK". Both packages run the search with
    its one-frame lookahead (HEVC_TPU_ME_PREFETCH_CPU=1 makes the reference
    do so on JAX-CPU); the prescreen and the deep search see int32
    planes."""
    monkeypatch.setenv("HEVC_TPU_ME_PREFETCH_CPU", "1")
    seen = {"screen": set(), "deep": set()}
    real_screen, real_deep = (intra_screen.intra_screen,
                              me_ssd._ssd_table_deep)

    def screen(plane, *a, **k):
        seen["screen"].add(plane.dtype)
        return real_screen(plane, *a, **k)

    def deep(roi, orig, **k):
        seen["deep"].add((roi.dtype, orig.dtype, k["depth"]))
        return real_deep(roi, orig, **k)
    monkeypatch.setattr(intra_screen, "intra_screen", screen)
    monkeypatch.setattr(me_ssd, "_ssd_table_deep", deep)
    w, h, n = 128, 80, 3
    chroma = label[-3:] if label.startswith("intra4") else "420"
    clip = tmp_path / "in16.yuv"
    _clip16(clip, w, h, n, chroma)
    args = (["-c", os.path.join(CFG_DIR, cfg), "-i", str(clip),
             "-wdt", str(w), "-hgt", str(h), "-f", str(n), "-fr", "30",
             "-q", "32", "--InputBitDepth=16", "--InternalBitDepth=16"]
            + ([f"--InputChromaFormat={chroma}"] if chroma != "420" else [])
            + ["--Profile=main-RExt"])
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
    dec = DecoderTop()
    assert sum(1 for _ in dec.decode_stream(got)) == n
    assert dec.hash_status == ["OK"] * n
    assert seen["screen"] == {torch.int32}
    if label in ("ldb", "ra"):
        assert seen["deep"] == {(torch.int32, torch.int32, 16)}
    else:
        assert not seen["deep"]


def _deep(p, depth):
    """A uint8 plane at 15 or 16 bits, int32: s << k | s & (2^k - 1)."""
    k = depth - 8
    return (p.astype(np.int32) << k) | (p & ((1 << k) - 1))


def _planes(kind, depth, w=96, h=64):
    """orig and a reference at `depth` bits: moving texture, or extremes
    (the texture with 16x16 patches of 0, 2^15 and 2^depth - 1)."""
    f = moving_frames(2, w, h, seed=depth)
    orig, ref = _deep(f[1][0], depth), _deep(f[0][0], depth)
    if kind == "extremes":
        top = (1 << depth) - 1
        for p in (orig, ref):
            for k, y0 in enumerate(range(0, h - 16, 24)):
                for j, x0 in enumerate(range(0, w - 16, 24)):
                    p[y0:y0 + 16, x0:x0 + 16] = (0, 1 << 15, top)[
                        (k + j + (p is ref)) % 3]
    return orig, ref


@pytest.mark.parametrize("kind", ["moving", "extremes"])
@pytest.mark.parametrize("size,r", [(8, 3), (16, 8), (32, 8)])
@pytest.mark.parametrize("depth", [15, 16])
def test_plain_ssd_table_deep_matches_jax(depth, size, r, kind):
    """The deep SSD table's plain version on int32 planes (shift 5 or 6
    to 10 effective bits) against the reference's three int8
    correlations."""
    orig, ref = _planes(kind, depth)
    refp = np.pad(ref, PAD, mode="edge")
    ny, nx = orig.shape[0] // size, orig.shape[1] // size
    aw = 2 * r + size
    roi = refp[PAD - r:PAD - r + (ny - 1) * size + aw,
               PAD - r:PAD - r + (nx - 1) * size + aw]
    with no_jax_cache_writes():
        exp = np.asarray(jax.jit(functools.partial(
            me_mxu._ssd_table_deep, size=size, r=r, ny=ny, nx=nx,
            depth=depth))(roi, orig))
    got = me_ssd._ssd_table_deep(torch.from_numpy(roi),
                                 torch.from_numpy(orig), size=size, r=r,
                                 ny=ny, nx=nx, depth=depth)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("kind", ["moving", "extremes"])
@pytest.mark.parametrize("size", [8, 16, 32])
@pytest.mark.parametrize("depth", [15, 16])
def test_plain_box_energies_match_jax(depth, size, kind):
    """The whole box plane of the centred squares of an int32 plane: with
    one block and 2r + 1 = the plane's side - size + 1 offsets, the
    reference's _window_energies returns its box plane unpermuted."""
    plane = _planes(kind, depth, 80, 80)[1][:2 * 24 + size, :2 * 24 + size]
    shift, mid = me_ssd.deep_centring(depth)
    assert shift == depth - 10 and mid == 512
    rc = (plane >> shift) - mid
    with no_jax_cache_writes():
        exp = np.asarray(jax.jit(functools.partial(
            me_mxu._window_energies, size=size, r=24, ny=1, nx=1))(
                rc * rc))[0]
    got = me_ssd.box_energies(torch.from_numpy(np.ascontiguousarray(plane)),
                              size, shift, mid)
    assert got.shape == exp.shape == (49, 49)
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("kind", ["moving", "extremes"])
@pytest.mark.parametrize("depth", [15, 16])
def test_plain_intra_screen_matches_reference(depth, kind):
    """The prescreen of every block size on an int32 plane (the reference
    carries 15-16-bit samples as int32 there too): candidates and costs."""
    y = _planes(kind, depth, 104, 72)[0]
    with no_jax_cache_writes():
        exp = jax_intra_screen.screen_frame_async(y, depth, 9.3)()
    got = intra_screen.screen_frame_async(y, depth, 9.3, device="cpu")()
    assert sorted(got) == sorted(exp) == [2, 3, 4, 5]
    for log2 in exp:
        for g, e in zip(got[log2], exp[log2]):
            np.testing.assert_array_equal(g, e)


# (w, o, denom): a fade, the identity, negative weight and offset, denom 0,
# the extremes of the syntax
TRIPLES = [(45, 12, 6), (64, 0, 6), (-20, 7, 3), (1, 5, 0),
           (-128, -128, 7), (255, 127, 7)]


@pytest.mark.parametrize("depth", [15, 16])
def test_plain_wp_apply_multi_matches_reference(depth):
    """wp_apply_multi's plain version on int32 planes against the
    reference's map of me_mxu.wp_apply over stacked planes (me_mxu.py
    lax.map), the clip to 2^depth - 1 and int32 arithmetic included."""
    rng = np.random.default_rng(depth)
    planes = rng.integers(0, 1 << depth, (len(TRIPLES), 40, 56)).astype(
        np.int32)
    planes[:, 0, :4] = (0, 1 << 15, (1 << depth) - 1, 1)
    wpvs = np.array(TRIPLES, np.int32)
    with no_jax_cache_writes():
        ref = np.asarray(jax.lax.map(
            lambda a: me_mxu.wp_apply(a[0], a[1], depth),
            (jnp.asarray(planes), jnp.asarray(wpvs))))
    got = me_ssd.wp_apply_multi([torch.from_numpy(p) for p in planes],
                                TRIPLES, depth)
    assert len(got) == len(TRIPLES)
    for g, e in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), e)
