"""The port's decoder (hevc_tpu_torch.decoder, cli/decode.py) against
hevc_tpu's on streams the port encodes on the CPU: low-delay P and
all-intra, 8 and 10 bits. Both decoders must give equal frames and check
every picture's MD5 SEI as "OK"; both CLIs must write the same YUV."""
import dataclasses

import numpy as np
import pytest

from hevc_tpu.cli.decode import main as jax_decode_main
from hevc_tpu.decoder.top import DecoderTop as JaxDecoderTop
from hevc_tpu_torch.cli.decode import main as port_decode_main
from hevc_tpu_torch.decoder.top import DecoderTop
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.io.cfg import EncoderConfig, parse_cfg_file
from test_torch_helpers import (INTRA_CFG, LDP_CFG, moving_frames,
                                private_reference_native)  # noqa: F401
from test_torch_helpers import one_torch_thread  # noqa: F401

# name: (cfg, width, height, frames, bit depth)
STREAMS = {"ldp": (LDP_CFG, 128, 80, 6, 8),
           "intra": (INTRA_CFG, 128, 80, 3, 8),
           "intra10": (INTRA_CFG, 96, 64, 2, 10)}


@pytest.fixture(scope="module")
def streams():
    """{name: (stream bytes, frame count)}, encoded by the port on the CPU."""
    out = {}
    for name, (path, w, h, n, bd) in STREAMS.items():
        cfg = parse_cfg_file(path, EncoderConfig())
        cfg.width, cfg.height, cfg.frames_to_encode = w, h, n
        cfg.input_bit_depth = cfg.internal_bit_depth = bd
        frames = [[(p.astype(np.int16) << (bd - 8)) if bd > 8 else p
                   for p in f] for f in moving_frames(n, w, h, seed=n + bd)]
        enc = EncoderTop(dataclasses.replace(cfg), device="cpu")
        data = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
        out[name] = (data, n)
    return out


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decoders_agree_and_hashes_ok(streams, name):
    data, n = streams[name]
    port, ref = DecoderTop(), JaxDecoderTop()
    got = list(port.decode_stream(data))
    exp = list(ref.decode_stream(data))
    assert len(got) == len(exp) == n
    for g, e in zip(got, exp):
        assert len(g) == len(e) == 3
        for a, b in zip(g, e):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert port.hash_status == ref.hash_status == ["OK"] * n
    assert port.sps.bit_depth_luma == STREAMS[name][4]


def test_decode_cli_writes_the_same_yuv(streams, tmp_path, capsys):
    data, n = streams["ldp"]
    bs = tmp_path / "ldp.bin"
    bs.write_bytes(data)
    assert port_decode_main(["-b", str(bs), "-o",
                             str(tmp_path / "port.yuv")]) == 0
    port_out = capsys.readouterr().out
    assert jax_decode_main(["-b", str(bs), "-o",
                            str(tmp_path / "ref.yuv")]) == 0
    port_yuv = (tmp_path / "port.yuv").read_bytes()
    assert len(port_yuv) == 128 * 80 * 3 // 2 * n
    assert port_yuv == (tmp_path / "ref.yuv").read_bytes()
    assert port_out.count("[hash OK]") == n
    assert "hash failures: 0" in port_out
