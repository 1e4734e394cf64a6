"""End-to-end parity: hevc_tpu_torch encodes byte-identical streams to
hevc_tpu on the CPU, for the same cfg (handed across with
config_from_reference) and the same input."""
import dataclasses
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

from hevc_tpu.encoder.top import EncoderTop as JaxEncoderTop
from hevc_tpu.io.cfg import EncoderConfig as JaxEncoderConfig
from hevc_tpu.io.cfg import parse_cfg_file as jax_parse_cfg_file
from hevc_tpu_torch.encoder import inter_frame
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.io.cfg import config_from_reference
from test_torch_helpers import (LDP_CFG, REPO, moving_frames,
                                no_jax_cache_writes,
                                private_reference_native)  # noqa: F401
from test_torch_helpers import one_torch_thread  # noqa: F401


def _ref_cfg(w, h, n, chroma=420):
    cfg = jax_parse_cfg_file(LDP_CFG, JaxEncoderConfig())
    cfg.width, cfg.height, cfg.frames_to_encode = w, h, n
    cfg.chroma_format = chroma
    return cfg


def _encode(enc, frames):
    out = b""
    for f in frames:
        out += enc.encode_frame(f)
    return out + enc.flush()


def _jax_encode(cfg, frames):
    with no_jax_cache_writes():
        return _encode(JaxEncoderTop(cfg), frames)


def _port_encode(cfg, frames):
    port_cfg = config_from_reference(dataclasses.asdict(cfg))
    return _encode(EncoderTop(port_cfg, device="cpu"), frames)


def test_config_from_reference_round_trip():
    cfg = _ref_cfg(128, 80, 8)
    port = config_from_reference(dataclasses.asdict(cfg))
    assert dataclasses.asdict(port) == dataclasses.asdict(cfg)
    assert [e.reference_pics for e in port.gop_entries] == [
        [-1, -5, -9, -13], [-1, -2, -6, -10], [-1, -3, -7, -11],
        [-1, -4, -8, -12]]
    with pytest.raises(ValueError):
        config_from_reference({"no_such_field": 1})


def test_ldp_four_refs_stream_identical(monkeypatch):
    """8-bit low-delay P, 12 frames: with the GOP's reference deltas the
    search runs against 1, 2, 3 and (from POC 10) 4 references, on both
    grids, and the streams are identical."""
    from hevc_tpu_torch.ops import me_ssd
    nrefs = []
    real = me_ssd.me_grids_multi2_async

    def spy(orig, refs, *a, **k):
        nrefs.append(len(refs))
        return real(orig, refs, *a, **k)
    monkeypatch.setattr(me_ssd, "me_grids_multi2_async", spy)
    frames = moving_frames(12, 128, 80, seed=5)
    cfg = _ref_cfg(128, 80, 12)
    ref = _jax_encode(cfg, frames)
    got = _port_encode(cfg, frames)
    assert len(got) > 0 and got == ref
    assert nrefs == [1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4]


def test_422_inter_fallback_stream_identical(monkeypatch):
    """4:2:2 inter takes the Python fallback encoder and its full search
    (the SAD-table path), in both packages."""
    calls = []
    real = inter_frame.full_search_batch_kernel

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(inter_frame, "full_search_batch_kernel", spy)
    frames = moving_frames(3, 64, 64, chroma=422, seed=6)
    cfg = _ref_cfg(64, 64, 3, chroma=422)
    ref = _jax_encode(cfg, frames)
    got = _port_encode(cfg, frames)
    assert got == ref
    assert len(calls) == 2        # one search per P frame


def test_422_10bit_inter_fallback_stream_identical(monkeypatch):
    """10-bit 4:2:2 inter (the fallback encoder's full search on samples
    above 255, the SAD kernel's float path on a card) gives the same
    stream in both packages."""
    calls = []
    real = inter_frame.full_search_batch_kernel

    def spy(*a, **k):
        calls.append((a[0].shape, int(a[0].max()), int(a[1].max())))
        return real(*a, **k)
    monkeypatch.setattr(inter_frame, "full_search_batch_kernel", spy)
    frames = [[(p.astype(np.int16) << 2) | (p & 3) for p in f]
              for f in moving_frames(3, 64, 64, chroma=422, seed=6)]
    cfg = _ref_cfg(64, 64, 3, chroma=422)
    cfg.input_bit_depth = cfg.internal_bit_depth = 10
    ref = _jax_encode(cfg, frames)
    got = _port_encode(cfg, frames)
    assert len(got) > 0 and got == ref
    assert len(calls) == 2        # one search per P frame
    assert all(max(b, a) > 255 for _, b, a in calls)


def test_reference_encode_unchanged_after_port_encode():
    """Both packages in one process: a port encode leaves hevc_tpu's own
    output untouched."""
    frames = moving_frames(3, 64, 64, seed=9)
    cfg = _ref_cfg(64, 64, 3)
    before = _jax_encode(cfg, frames)
    port = _port_encode(cfg, frames)
    after = _jax_encode(cfg, frames)
    assert after == before
    assert port == before


def test_cli_lookahead_matches_reference_device_path(tmp_path, monkeypatch):
    """Both CLIs on the same clip, with the one-frame ME lookahead running:
    the port's (as on a card) against hevc_tpu's device orchestration on
    JAX-CPU (HEVC_TPU_ME_PREFETCH_CPU=1). Every P frame takes its grids
    from the lookahead: the encoder's counters say so."""
    from hevc_tpu.cli.encode import main as jax_main
    from hevc_tpu_torch.cli.encode import main as port_main
    from hevc_tpu_torch.utils.timing import timers
    w, h, n = 128, 80, 6
    clip = tmp_path / "clip.yuv"
    with open(clip, "wb") as fh:
        for planes in moving_frames(n, w, h, seed=12):
            for p in planes:
                fh.write(p.tobytes())
    args = ["-c", LDP_CFG, "-i", str(clip), "-wdt", str(w), "-hgt", str(h),
            "-f", str(n)]
    timers.reset()
    monkeypatch.setattr(timers, "enabled", True)
    assert port_main(args + ["-b", str(tmp_path / "port.bin")],
                     device="cpu") == 0
    count = dict(timers.count)
    monkeypatch.setattr(timers, "enabled", False)
    timers.reset()
    monkeypatch.setenv("HEVC_TPU_ME_PREFETCH_CPU", "1")
    with no_jax_cache_writes():
        assert jax_main(args + ["-b", str(tmp_path / "ref.bin")]) == 0
    port = (tmp_path / "port.bin").read_bytes()
    ref = (tmp_path / "ref.bin").read_bytes()
    assert hashlib.md5(port).hexdigest() == hashlib.md5(ref).hexdigest()
    assert count["me_lookahead_taken"] == count["me_searched"] == n - 1


def test_cuda_request_without_card_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        EncoderTop(config_from_reference(
            dataclasses.asdict(_ref_cfg(64, 64, 1))))


_THREADED_WORKER = r"""
import sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/tests"]
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.entropy.cabac import engine_frame_stats
from hevc_tpu_torch.io.cfg import EncoderConfig, parse_cfg_file
from hevc_tpu_torch.utils.timing import timers
from test_torch_helpers import LDP_CFG, textured_frames
w, h = int(sys.argv[2]), int(sys.argv[3])
cfg = parse_cfg_file(LDP_CFG, EncoderConfig())
cfg.width, cfg.height, cfg.frames_to_encode = w, h, 3
cfg.search_range = 16
enc = EncoderTop(cfg, device="cpu")
frames = textured_frames(3, w, h)
timers.enabled = True  # the engine's counters: rows that changed hands
out = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
sys.stdout.buffer.write(out)
sys.stderr.write("row_switches %d\n" % engine_frame_stats()["engine_row_switches"])
"""


def _threaded_encode(nthreads, w=320, h=256):
    """The worker above in a subprocess: a w x h encode of three pictures
    on the native engine's lag-2 wavefront. Returns the stream and the
    number of times a CTU row changed hands between workers."""
    env = dict(os.environ, HEVC_TPU_THREADS=str(nthreads),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _THREADED_WORKER, REPO,
                        str(w), str(h)],
                       env=env, capture_output=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:].decode(errors="replace")
    assert len(r.stdout) > 1000
    return r.stdout, int(r.stderr.split()[-1])


def test_wavefront_threads_deterministic():
    """The stream may not depend on the wavefront's thread count or on
    scheduling: the worker threads share one engine object, so every
    scratch buffer they write must be per thread. (The inter-TB level
    buffer once was shared: a row could overwrite another's levels between
    quantization and copy-out, and the CU then kept a nonzero count with
    all-zero levels and aborted in residual() on 640x360 and 1080p.)
    At 640x384 (six CTU rows) fewer workers than rows take a row up where
    another worker let it go, so a CTU's left neighbour may have been
    coded by another thread; the stream stays the same at 2, 3, 4 and 8
    threads (8 are capped at the six rows)."""
    ref = _threaded_encode(2)[0]
    assert _threaded_encode(4)[0] == ref
    assert _threaded_encode(4)[0] == ref
    ref, switches = _threaded_encode(2, 640, 384)
    assert switches > 0
    for n in (3, 4, 8):
        assert _threaded_encode(n, 640, 384)[0] == ref
