"""Two switches of the shared C++ engine, held to hevc_tpu on the CPU:
GPUModeME=1 (the reference-GPU-mode motion search, its per-CTU
partition tables computed by the engine) and HEVC_TPU_FAST_SPLIT=1 (the
engine settles ambiguous intra and inter splits by the prescreen instead
of the exact trial). The engine reads HEVC_TPU_FAST_SPLIT once per process
into a static, so each package encodes with it in a subprocess of its
own; the port's stream is also held to differ from its default one, so
that the switch is seen to act."""
import json
import os
import subprocess
import sys

import pytest

from hevc_tpu.cli.encode import main as jax_main
from hevc_tpu_torch.cli.encode import main as port_main
from hevc_tpu_torch.decoder.top import DecoderTop
from test_torch_helpers import (INTRA_CFG, LDP_CFG, REPO,
                                no_jax_cache_writes, reference_native_lib,
                                private_reference_native)  # noqa: F401
from test_torch_helpers import one_torch_thread  # noqa: F401

W, H = 192, 128


def _clip(path, n):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from make_test_yuv import write_clip
    write_clip(str(path), W, H, n)


def _decode_ok(stream, n):
    dec = DecoderTop()
    assert sum(1 for _ in dec.decode_stream(stream)) == n
    assert dec.hash_status == ["OK"] * n


def test_gpu_mode_me_stream_identical(tmp_path):
    """GPUModeME=1 at SearchRange 8 (the reference's end-to-end GPU-mode
    test): byte-identical, every MD5 SEI "OK"."""
    n = 3
    clip = tmp_path / "in.yuv"
    _clip(clip, n)
    args = ["-i", str(clip), "-wdt", str(W), "-hgt", str(H), "-f", str(n),
            "-q", "34", "--SearchRange=8", "--GPUModeME=1", "-fr", "30"]
    with no_jax_cache_writes():
        jax_main(args + ["-b", str(tmp_path / "ref.bin")])
    port_main(args + ["-b", str(tmp_path / "port.bin")], device="cpu")
    got = (tmp_path / "port.bin").read_bytes()
    assert len(got) > 0 and got == (tmp_path / "ref.bin").read_bytes()
    _decode_ok(got, n)


# case -> (cfg, frames): all-intra (the intra split gate) and low-delay P
# (the inter split trial)
FAST_CASES = {"intra": (INTRA_CFG, 2), "ldp": (LDP_CFG, 3)}

# encode every case of FAST_CASES with one package's CLI; argv: package,
# the reference's native library, the clip directory, the cases as JSON
_WORKER = r"""
import json
import sys
pkg, lib, tmp, cases = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
if pkg == "hevc_tpu":
    from hevc_tpu.entropy import cabac
    cabac._LIB_PATH = lib
    from hevc_tpu.cli.encode import main
    run = main
else:
    from hevc_tpu_torch.cli.encode import main
    run = lambda a: main(a, device="cpu")
for name, (cfg, n, w, h) in json.loads(cases).items():
    run(["-c", cfg, "-i", f"{tmp}/{name}.yuv", "-wdt", str(w), "-hgt",
         str(h), "-f", str(n), "-b", f"{tmp}/{name}.{pkg}.bin"])
"""


@pytest.fixture(scope="module")
def fast_split_streams(tmp_path_factory):
    """{case: (reference stream, port stream)} under HEVC_TPU_FAST_SPLIT=1,
    each package in a subprocess (both search without the one-frame
    lookahead, HEVC_TPU_ME_PREFETCH=0, which the reference runs on JAX-CPU
    only when asked)."""
    tmp = tmp_path_factory.mktemp("fast_split")
    for name, (_, n) in FAST_CASES.items():
        _clip(tmp / f"{name}.yuv", n)
    cases = json.dumps({k: (cfg, n, W, H)
                        for k, (cfg, n) in FAST_CASES.items()})
    env = dict(os.environ, HEVC_TPU_FAST_SPLIT="1", JAX_PLATFORMS="cpu",
               HEVC_TPU_PLATFORM="cpu", HEVC_TPU_ME_PREFETCH="0",
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1e9",
               OMP_NUM_THREADS="1")
    lib = reference_native_lib()
    for pkg in ("hevc_tpu", "hevc_tpu_torch"):
        out = subprocess.run(
            [sys.executable, "-c", _WORKER, pkg, lib, str(tmp), cases],
            cwd=REPO, env=env, capture_output=True, text=True)
        assert out.returncode == 0, out.stderr[-3000:]
    return {k: ((tmp / f"{k}.hevc_tpu.bin").read_bytes(),
                (tmp / f"{k}.hevc_tpu_torch.bin").read_bytes())
            for k in FAST_CASES}


@pytest.mark.parametrize("case", sorted(FAST_CASES))
def test_fast_split_stream_identical(monkeypatch, tmp_path,
                                     fast_split_streams, case):
    ref, got = fast_split_streams[case]
    assert len(got) > 0 and got == ref
    cfg, n = FAST_CASES[case]
    _decode_ok(got, n)
    # the default (exact split trial) stream of the same clip differs
    monkeypatch.setenv("HEVC_TPU_ME_PREFETCH", "0")
    clip = tmp_path / "in.yuv"
    _clip(clip, n)
    port_main(["-c", cfg, "-i", str(clip), "-wdt", str(W), "-hgt", str(H),
               "-f", str(n), "-b", str(tmp_path / "default.bin")],
              device="cpu")
    assert (tmp_path / "default.bin").read_bytes() != got
