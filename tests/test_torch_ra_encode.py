"""Random access, Main10 random access and low-delay B: hevc_tpu_torch's
copies of HM-16.4's encoder_randomaccess_main.cfg,
encoder_randomaccess_main10.cfg and encoder_lowdelay_main.cfg parse to the
same configuration in both packages, and both packages encode
byte-identical streams with them on the CPU (the hierarchical-B GOP of
eight with its CRA period, the deep-bit-depth search at 10 bits, and B
pictures whose two lists hold the same pictures). The port's decoder
checks every picture's MD5 SEI of its streams."""
import dataclasses
import os

import pytest

from hevc_tpu.encoder.top import EncoderTop as JaxEncoderTop
from hevc_tpu.io.cfg import EncoderConfig as JaxEncoderConfig
from hevc_tpu.io.cfg import parse_cfg_file as jax_parse_cfg_file
from hevc_tpu_torch.decoder.top import DecoderTop
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.io.cfg import EncoderConfig, config_from_reference
from hevc_tpu_torch.io.cfg import parse_cfg_file
from hevc_tpu_torch.ops import me_ssd
from test_torch_helpers import (CFG_DIR, at_depth, moving_frames,
                                no_jax_cache_writes,
                                private_reference_native)  # noqa: F401
from test_torch_helpers import one_torch_thread  # noqa: F401

RA = "encoder_randomaccess_main.cfg"
RA10 = "encoder_randomaccess_main10.cfg"
LDB = "encoder_lowdelay_main.cfg"


@pytest.mark.parametrize("name", [RA, RA10, LDB])
def test_new_cfgs_parse_equal_in_both_packages(name):
    path = os.path.join(CFG_DIR, name)
    ref = jax_parse_cfg_file(path, JaxEncoderConfig())
    port = parse_cfg_file(path, EncoderConfig())
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert config_from_reference(dataclasses.asdict(ref)) == port
    assert all(e.slice_type == "B" for e in port.gop_entries)
    assert (port.qp, port.search_range, port.sao, port.amp) == (
        32, 64, True, True)
    if name == LDB:
        assert (port.intra_period, port.gop_size) == (-1, 4)
        assert port.gop_entries[0].reference_pics == [-1, -5, -9, -13]
        assert {e.num_ref_pics_active for e in port.gop_entries} == {4}
        return
    assert (port.intra_period, port.decoding_refresh_type,
            port.gop_size) == (32, 1, 8)
    assert [e.poc for e in port.gop_entries] == [8, 4, 2, 1, 3, 6, 5, 7]
    assert {e.num_ref_pics_active for e in port.gop_entries} == {2}
    assert (port.profile, port.internal_bit_depth) == (
        ("main10", 10) if name == RA10 else ("main", 8))


@pytest.mark.parametrize("name,w,h,n", [(RA, 96, 64, 9), (RA10, 96, 64, 9),
                                        (LDB, 128, 64, 6)])
def test_b_gop_stream_identical(monkeypatch, name, w, h, n):
    """RA: the IDR and one hierarchical-B GOP of eight, coded out of order
    with references on both sides; RA Main10: the same at 10 bits, where
    every search goes through the deep SSD table; LDB: B pictures whose
    lists hold the same past pictures (one search each)."""
    calls = {"deep": 0, "8bit": 0}
    real_deep, real_8 = me_ssd._ssd_table_deep, me_ssd._ssd_table

    def deep(*a, **k):
        calls["deep"] += 1
        return real_deep(*a, **k)

    def shallow(*a, **k):
        calls["8bit"] += 1
        return real_8(*a, **k)
    monkeypatch.setattr(me_ssd, "_ssd_table_deep", deep)
    monkeypatch.setattr(me_ssd, "_ssd_table", shallow)
    cfg = jax_parse_cfg_file(os.path.join(CFG_DIR, name), JaxEncoderConfig())
    cfg.width, cfg.height, cfg.frames_to_encode = w, h, n
    cfg.input_bit_depth = cfg.internal_bit_depth
    frames = [[at_depth(p, cfg.internal_bit_depth) for p in f]
              for f in moving_frames(n, w, h, seed=n + w)]
    with no_jax_cache_writes():
        enc = JaxEncoderTop(cfg)
        ref = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    enc = EncoderTop(config_from_reference(dataclasses.asdict(cfg)),
                     device="cpu")
    got = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
    assert len(got) > 0 and got == ref
    if name == RA10:
        assert calls["deep"] > 0 and calls["8bit"] == 0
    else:
        assert calls["8bit"] > 0 and calls["deep"] == 0
    dec = DecoderTop()
    assert sum(1 for _ in dec.decode_stream(got)) == n
    assert dec.hash_status == ["OK"] * n
