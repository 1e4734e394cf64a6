"""All-intra parity: hevc_tpu_torch with its copy of HM-16.4's
encoder_intra_main.cfg encodes byte-identical streams to hevc_tpu on the
CPU, for 8- and 10-bit 4:2:0 and 8-bit 4:4:4 (the native engine with the
device prescreen on every picture) and 8-bit 4:2:2 (the Python intra
encoder, no prescreen)."""
import dataclasses

import numpy as np
import pytest

from hevc_tpu.encoder.top import EncoderTop as JaxEncoderTop
from hevc_tpu.io.cfg import EncoderConfig as JaxEncoderConfig
from hevc_tpu.io.cfg import parse_cfg_file as jax_parse_cfg_file
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.io.cfg import EncoderConfig, config_from_reference
from hevc_tpu_torch.io.cfg import parse_cfg_file
from hevc_tpu_torch.ops import intra_screen
from test_torch_helpers import (INTRA_CFG, moving_frames,
                                no_jax_cache_writes,
                                private_reference_native)  # noqa: F401
from test_torch_helpers import one_torch_thread  # noqa: F401


def _frames(n, w, h, chroma, bit_depth, seed):
    """n frames [Y, Cb, Cr] of moving texture at the given chroma format,
    scaled to bit_depth (int16 samples above 8 bits)."""
    base = moving_frames(n, w, h, chroma=420 if chroma == 444 else chroma,
                         seed=seed)
    out = []
    for y, u, v in base:
        if chroma == 444:
            u, v = (y // 2 + 32).astype(np.uint8), (y // 3 + 48).astype(
                np.uint8)
        planes = [y, u, v]
        if bit_depth > 8:
            planes = [(p.astype(np.int16) << (bit_depth - 8)) | 1
                      for p in planes]
        out.append(planes)
    return out


def _encode(enc, frames):
    return b"".join(enc.encode_frame(f) for f in frames) + enc.flush()


def test_intra_cfg_parses_equal_in_both_packages():
    ref = jax_parse_cfg_file(INTRA_CFG, JaxEncoderConfig())
    port = parse_cfg_file(INTRA_CFG, EncoderConfig())
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert config_from_reference(dataclasses.asdict(ref)) == port
    assert (port.intra_period, port.gop_size, port.gop_entries) == (1, 1, [])
    assert (port.qp, port.internal_bit_depth, port.sao, port.amp) == (
        32, 8, True, True)


@pytest.mark.parametrize("chroma,bit_depth,w,h", [(420, 8, 128, 80),
                                                  (420, 10, 96, 64),
                                                  (422, 8, 64, 64),
                                                  (444, 8, 64, 64)])
def test_all_intra_stream_identical(monkeypatch, chroma, bit_depth, w, h):
    """Three pictures, each an intra picture. At 4:2:0 and 4:4:4 every
    picture runs the port's prescreen exactly once (its plain version
    here); 4:2:2 takes the Python intra encoder in both packages."""
    calls = []
    real = intra_screen.intra_screen

    def spy(plane, *a, **k):
        calls.append(tuple(plane.shape))
        return real(plane, *a, **k)
    monkeypatch.setattr(intra_screen, "intra_screen", spy)
    n = 3
    cfg = jax_parse_cfg_file(INTRA_CFG, JaxEncoderConfig())
    cfg.width, cfg.height, cfg.frames_to_encode = w, h, n
    cfg.chroma_format = chroma
    cfg.input_bit_depth = cfg.internal_bit_depth = bit_depth
    frames = _frames(n, w, h, chroma, bit_depth, seed=bit_depth + chroma)
    with no_jax_cache_writes():
        ref = _encode(JaxEncoderTop(cfg), frames)
    port_cfg = config_from_reference(dataclasses.asdict(cfg))
    got = _encode(EncoderTop(port_cfg, device="cpu"), frames)
    assert len(got) > 0 and got == ref
    assert calls == ([] if chroma == 422 else [(h + 1, w + 1)] * n)


def test_cli_all_intra_lookahead_matches_reference(tmp_path, monkeypatch):
    """Both CLIs with the all-intra cfg, as the card runs it: the
    prescreen is queued three pictures ahead. One warm-up call and one
    call per picture, each picture taking its hints from the queue, and
    the streams are identical."""
    from hevc_tpu.cli.encode import main as jax_main
    from hevc_tpu_torch.cli.encode import main as port_main
    w, h, n = 128, 80, 5
    clip = tmp_path / "clip.yuv"
    with open(clip, "wb") as fh:
        for planes in moving_frames(n, w, h, seed=3):
            for p in planes:
                fh.write(p.tobytes())
    calls = []
    real = intra_screen.intra_screen

    def spy(plane, *a, **k):
        calls.append(tuple(plane.shape))
        return real(plane, *a, **k)
    monkeypatch.setattr(intra_screen, "intra_screen", spy)
    args = ["-c", INTRA_CFG, "-i", str(clip), "-wdt", str(w), "-hgt",
            str(h), "-f", str(n)]
    assert port_main(args + ["-b", str(tmp_path / "port.bin")],
                     device="cpu") == 0
    with no_jax_cache_writes():
        assert jax_main(args + ["-b", str(tmp_path / "ref.bin")]) == 0
    port = (tmp_path / "port.bin").read_bytes()
    assert len(port) > 0 and port == (tmp_path / "ref.bin").read_bytes()
    assert calls == [(h + 1, w + 1)] * (n + 1)
