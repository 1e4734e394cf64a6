"""The range extensions (RExt) in hevc_tpu_torch: its copies of HM-16.4's
encoder_intra_high_throughput_rext.cfg and the three *_main_rext.cfg parse
to the same configuration in both packages; the high-throughput 4:4:4
intra configuration (10-bit internal by default, and at 8 bits) and the
high-throughput tool set (transform-skip residual rotation, the single
significance-map context, persistent Golomb-Rice adaptation and CABAC
bypass alignment) encode byte-identical streams in both packages on the
CPU; the port's decoder checks every picture's MD5 SEI, and the SPS
carries the four range-extension flags."""
import dataclasses
import os
import sys

import numpy as np
import pytest

from hevc_tpu.cli.encode import main as jax_main
from hevc_tpu.io.cfg import EncoderConfig as JaxEncoderConfig
from hevc_tpu.io.cfg import parse_cfg_file as jax_parse_cfg_file
from hevc_tpu_torch.cli.encode import main as port_main
from hevc_tpu_torch.decoder import headers as port_headers
from hevc_tpu_torch.decoder.top import DecoderTop
from hevc_tpu_torch.entropy.nal import nal_to_rbsp, split_annexb
from hevc_tpu_torch.io.cfg import EncoderConfig, config_from_reference
from hevc_tpu_torch.io.cfg import parse_cfg_file
from test_torch_helpers import (CFG_DIR, REPO, no_jax_cache_writes,
                                private_reference_native)  # noqa: F401
from test_torch_helpers import one_torch_thread  # noqa: F401

HT = "encoder_intra_high_throughput_rext.cfg"
INTRA = "encoder_intra_main_rext.cfg"
LDB = "encoder_lowdelay_main_rext.cfg"
RA = "encoder_randomaccess_main_rext.cfg"
HT_TOOLS = ["--TransformSkip=1", "--ResidualRotation=1",
            "--SingleSignificanceMapContext=1",
            "--GolombRiceParameterAdaptation=1", "--AlignCABACBeforeBypass=1"]


@pytest.mark.parametrize("name", [HT, INTRA, LDB, RA])
def test_rext_cfgs_parse_equal_in_both_packages(name):
    path = os.path.join(CFG_DIR, name)
    ref = jax_parse_cfg_file(path, JaxEncoderConfig())
    port = parse_cfg_file(path, EncoderConfig())
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert config_from_reference(dataclasses.asdict(ref)) == port
    assert port.profile == "main-RExt"
    assert (port.extended_precision, port.ts_log2_max,
            port.intra_ref_smoothing) == (0, 2, 1)
    assert (port.residual_rotation, port.single_sig_ctx,
            port.rice_adaptation, port.cross_comp_pred) == (1, 1, 1, 1)
    assert port.align_cabac_bypass == (1 if name == HT else 0)
    assert port.internal_bit_depth == (10 if name == HT else 8)
    assert (port.qp, port.sao, port.amp, port.transform_skip) == (
        32, True, True, True)
    if name in (HT, INTRA):
        assert (port.intra_period, port.gop_size) == (1, 1)
    elif name == LDB:
        assert (port.intra_period, port.gop_size) == (-1, 4)
        assert port.gop_entries[0].reference_pics == [-1, -5, -9, -13]
    else:
        assert (port.intra_period, port.decoding_refresh_type,
                port.gop_size) == (32, 1, 8)
        assert [e.poc for e in port.gop_entries] == [8, 4, 2, 1, 3, 6, 5, 7]


def _clip_444(path, w, h, n, seed=9):
    """4:4:4 8-bit clip (the reference's RExt 4:4:4 conformance content:
    sinusoids plus noise in every plane)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    with open(path, "wb") as f:
        for i in range(n):
            y = ((np.sin(xx / 7 + i) + np.cos(yy / 5)) * 50 + 128
                 + rng.integers(-20, 20, (h, w))).clip(0, 255)
            u = ((np.sin(xx / 11) * 60) + 128
                 + rng.integers(-15, 15, (h, w))).clip(0, 255)
            v = ((np.cos(yy / 9) * 60) + 128
                 + rng.integers(-15, 15, (h, w))).clip(0, 255)
            for p in (y, u, v):
                f.write(p.astype(np.uint8).tobytes())


def _encode_both(tmp_path, args):
    """The same CLI arguments through both packages (the port on the CPU):
    (reference stream, port stream)."""
    out = []
    for tag, run in (("ref", jax_main),
                     ("port", lambda a: port_main(a, device="cpu"))):
        bs = tmp_path / f"{tag}.bin"
        with no_jax_cache_writes():
            assert run(args + ["-b", str(bs),
                               "-o", str(tmp_path / f"{tag}.yuv")]) in (
                0, None)
        out.append(bs.read_bytes())
    return out


def _decode_ok(stream, n):
    dec = DecoderTop()
    assert sum(1 for _ in dec.decode_stream(stream)) == n
    assert dec.hash_status == ["OK"] * n
    return dec


@pytest.mark.parametrize("extra", [[], ["--InternalBitDepth=8"]],
                         ids=["10bit", "8bit"])
def test_high_throughput_444_stream_identical(tmp_path, extra):
    """The fifth bench configuration: 4:4:4 all-intra under the
    high-throughput cfg (10-bit internal by default, then 8-bit),
    176x144, 2 frames, QP 34, as the reference's conformance test runs it.
    4:4:4 intra runs the native engine with cross-component prediction."""
    w, h, n = 176, 144, 2
    clip = tmp_path / "in444.yuv"
    _clip_444(clip, w, h, n)
    ref, got = _encode_both(tmp_path, [
        "-c", os.path.join(CFG_DIR, HT), "-i", str(clip), "-wdt", str(w),
        "-hgt", str(h), "-f", str(n), "-q", "34",
        "--InputChromaFormat=444"] + extra)
    assert len(got) > 0 and got == ref
    _decode_ok(got, n)
    sps = _sps(got)
    assert sps.chroma_format_idc == 3
    assert sps.bit_depth_luma == (8 if extra else 10)
    assert sps.cabac_bypass_alignment_enabled_flag


def _sps(stream):
    for u in split_annexb(stream):
        t, _tid, r = nal_to_rbsp(bytes(u))
        if t == 33:
            return port_headers.parse_sps(bytes(r))
    raise AssertionError("no SPS in the stream")


@pytest.mark.parametrize("extra,frames", [
    (["--IntraPeriod=1"], 2),
    (["--IntraPeriod=-1", "-q", "37"], 4),
], ids=["intra", "inter"])
def test_high_throughput_tool_set_stream_identical(monkeypatch, tmp_path,
                                                   extra, frames):
    """The encode-side high-throughput tool set at 416x240 (all-intra, and
    an IDR followed by P pictures, which run the device search), with the
    reference's conformance arguments: byte-identical, the four SPS
    range-extension flags set, every MD5 SEI "OK". Both packages run the
    search without its one-frame lookahead (HEVC_TPU_ME_PREFETCH=0): on
    JAX-CPU the reference runs the lookahead only when asked, and then
    compiles its search programs for minutes at this size."""
    monkeypatch.setenv("HEVC_TPU_ME_PREFETCH", "0")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_test_yuv import write_clip
    w, h = 416, 240
    clip = tmp_path / "in.yuv"
    write_clip(str(clip), w, h, frames)
    ref, got = _encode_both(tmp_path, [
        "-i", str(clip), "-wdt", str(w), "-hgt", str(h), "-f", str(frames),
        "-q", "30"] + HT_TOOLS + extra)
    assert len(got) > 0 and got == ref
    _decode_ok(got, frames)
    sps = _sps(got)
    assert sps.transform_skip_rotation_enabled_flag
    assert sps.transform_skip_context_enabled_flag
    assert sps.persistent_rice_adaptation_enabled_flag
    assert sps.cabac_bypass_alignment_enabled_flag
