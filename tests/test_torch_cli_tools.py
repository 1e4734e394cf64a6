"""The port's host CLI tools (cli/annexb_bytecount.py, cli/convert_bitdepth.py,
cli/bitrate_targeting.py) give the same output as hevc_tpu/cli's on the
same input."""
import numpy as np
import pytest

from hevc_tpu.cli import annexb_bytecount as jax_bytecount
from hevc_tpu.cli import bitrate_targeting as jax_targeting
from hevc_tpu.cli import convert_bitdepth as jax_convert
from hevc_tpu_torch.cli import annexb_bytecount, bitrate_targeting
from hevc_tpu_torch.cli import convert_bitdepth
from hevc_tpu_torch.cli.encode import main as encode_main
from test_torch_helpers import (INTRA_CFG, LDP_CFG, moving_frames,
                                no_jax_cache_writes,
                                private_reference_native)  # noqa: F401
from test_torch_helpers import one_torch_thread  # noqa: F401


def _clip(path, w, h, n, bit_depth=8, seed=4):
    """n 4:2:0 frames of moving texture, 16-bit little-endian above 8
    bits."""
    with open(path, "wb") as fh:
        for planes in moving_frames(n, w, h, seed=seed):
            for p in planes:
                if bit_depth > 8:
                    p = (p.astype("<u2") << (bit_depth - 8)) | (p & 3)
                fh.write(p.tobytes())


def test_annexb_bytecount_matches_reference(tmp_path, capsys):
    _clip(tmp_path / "c.yuv", 64, 64, 3)
    bs = str(tmp_path / "o.bin")
    assert encode_main(["-c", LDP_CFG, "-i", str(tmp_path / "c.yuv"),
                        "-wdt", "64", "-hgt", "64", "-f", "3", "-b", bs],
                       device="cpu") == 0
    capsys.readouterr()
    assert annexb_bytecount.SELFTEST_VECTORS == jax_bytecount.SELFTEST_VECTORS
    outs = []
    for tool in (annexb_bytecount, jax_bytecount):
        assert tool.selftest()
        assert tool.main([bs]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "selftest passed" in outs[0] and "total NAL units" in outs[0]


@pytest.mark.parametrize("in_bd,out_bd", [(8, 10), (10, 8), (10, 12)])
def test_convert_bitdepth_matches_reference(tmp_path, capsys, in_bd, out_bd):
    w, h, n = 48, 32, 2
    _clip(tmp_path / "in.yuv", w, h, n, bit_depth=in_bd)
    outs = []
    for tool, name in ((convert_bitdepth, "port.yuv"),
                       (jax_convert, "ref.yuv")):
        assert tool.main([str(tmp_path / "in.yuv"), str(tmp_path / name),
                          str(w), str(h), str(in_bd), str(out_bd)]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == f"converted {n} frames {in_bd}->{out_bd} bit\n"
    port = (tmp_path / "port.yuv").read_bytes()
    assert port == (tmp_path / "ref.yuv").read_bytes()
    size = w * h * 3 // 2 * n * (2 if out_bd > 8 else 1)
    assert len(port) == size
    if out_bd > 8:
        assert np.frombuffer(port, "<u2").max() < (1 << out_bd)


def test_bitrate_targeting_matches_reference(tmp_path, capsys):
    """The QP bisection over real encodes (all-intra, two 64x48 pictures):
    both tools visit the same QPs with the same rates and pick the same
    one."""
    _clip(tmp_path / "c.yuv", 64, 48, 2, seed=6)
    args = ["-c", INTRA_CFG, "-i", str(tmp_path / "c.yuv"), "-wdt", "64",
            "-hgt", "48", "-f", "2", "--TargetKbps", "300"]
    assert bitrate_targeting.main(args, device="cpu") == 0
    port = capsys.readouterr().out
    with no_jax_cache_writes():
        assert jax_targeting.main(args) == 0
    ref = capsys.readouterr().out

    def steps(out):
        return [ln for ln in out.splitlines()
                if ln.startswith(("QP ", "best QP"))]
    assert len(steps(port)) >= 3 and steps(port)[-1].startswith("best QP")
    assert steps(port) == steps(ref)
