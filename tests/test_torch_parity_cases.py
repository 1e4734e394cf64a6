"""Coding tools beyond the cfgs' defaults: both packages' CLIs, with HM's
low-delay P settings and one option on top, encode byte-identical streams
of the same clip on the CPU (4:0:0, rate control, adaptive QP with delta
QP, wavefront parallel processing, scaling lists). The port's decoder
checks every picture's MD5 SEI of its stream."""
import numpy as np
import pytest

from hevc_tpu_torch.decoder.top import DecoderTop
from test_torch_helpers import (LDP_CFG, moving_frames, no_jax_cache_writes,
                                private_reference_native)  # noqa: F401
from test_torch_helpers import one_torch_thread  # noqa: F401

# option -> extra CLI arguments; 4:0:0 inter takes the host fallback
# encoder, whose JAX search compiles anew for every reference count (about
# 10 s each), so its clip is one CTU and one P picture
CASES = {
    "ldp_400": ["--InputChromaFormat=400", "--Profile=main-RExt"],
    "rate_control": ["--RateControl=1", "--TargetBitrate=150000"],
    "aq_dqp": ["--AdaptiveQP=1", "--MaxCuDQPDepth=1"],
    "wpp": ["--WaveFrontSynchro=1"],
    "scaling_list": ["--ScalingList=1"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_option_stream_identical(tmp_path, case):
    from hevc_tpu.cli.encode import main as jax_main
    from hevc_tpu_torch.cli.encode import main as port_main
    w, h, n = (64, 64, 2) if case == "ldp_400" else (128, 128, 3)
    clip = tmp_path / "clip.yuv"
    with open(clip, "wb") as fh:
        for planes in moving_frames(n, w, h, seed=len(case)):
            for p in planes[:1] if case == "ldp_400" else planes:
                fh.write(np.ascontiguousarray(p).tobytes())
    args = ["-c", LDP_CFG, "-i", str(clip), "-wdt", str(w), "-hgt", str(h),
            "-f", str(n)] + CASES[case]
    assert port_main(args + ["-b", str(tmp_path / "port.bin")],
                     device="cpu") == 0
    with no_jax_cache_writes():
        assert jax_main(args + ["-b", str(tmp_path / "ref.bin")]) == 0
    port = (tmp_path / "port.bin").read_bytes()
    assert len(port) > 0 and port == (tmp_path / "ref.bin").read_bytes()
    dec = DecoderTop()
    assert sum(1 for _ in dec.decode_stream(port)) == n
    assert dec.hash_status == ["OK"] * n
