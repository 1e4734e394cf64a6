"""ThreadSanitizer run of the port's threaded CU engine (the `make tsan`
build of hevc_tpu_torch/entropy/native, its runtime preloaded): a data
race between the lag-2 wavefront rows (api.cpp hevc_engine_frame) aborts
the subprocess (halt_on_error). The encode covers seven CTU rows of an
inter picture with partial and split CTUs, where the shared inter level
scratch (CtuEngine::lev_tmp_, per thread since the port's first slice)
raced in 1080p encodes. Python, numpy and torch are not instrumented; the
port's tsan.supp suppresses reports by those libraries only, never by a
symbol of the engine. The run is made with the encoder's tracing off and
on: on, every worker also keeps the engine's trace counters in
thread-local sums and hands them to the frame once, under its lock."""
import os
import subprocess
import sys

import pytest

from hevc_tpu_torch.entropy import cabac

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "hevc_tpu_torch", "entropy", "native")

# an IDR and a P picture of 200x392 (chip_smoke.py's textured content):
# seven CTU rows of four CTUs, up to seven rows at once in the wavefront;
# the last column and row are partial CTUs, which the engine codes by its
# quadtree walk (encode_cu_inter), as it codes textured CTUs that split;
# argv: 1 to encode with the timers (and so the engine's trace) on
_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from chip_smoke import clip_frames
w, h, n = 200, 392, 2
frames = [[p.astype(np.int16) for p in f] for f in clip_frames(w, h, n, 1)]
from hevc_tpu_torch.io.cfg import EncoderConfig
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.entropy.cabac import engine_frame_stats
from hevc_tpu_torch.utils.timing import timers
timers.enabled = sys.argv[1] == "1"
cfg = EncoderConfig(width=w, height=h, qp=30, intra_period=-1,
                    frames_to_encode=n)
enc = EncoderTop(cfg, device="cpu")
out = b"".join(enc.encode_frame(f) for f in frames) + enc.flush()
traced = engine_frame_stats()["engine_traced_frames"]
assert traced == (n if timers.enabled else 0), traced
sys.stdout.buffer.write(out)
"""


@pytest.mark.parametrize("trace", [False, True], ids=["off", "traced"])
def test_wavefront_under_tsan(trace):
    """Eight wavefront threads over seven CTU rows under ThreadSanitizer
    (halt_on_error): the encode must finish and write a stream. With the
    level scratch shared again (a plain member of CtuEngine) this run
    reports the race in encode_cu_inter and fails."""
    tsan_rt = subprocess.run(["g++", "-print-file-name=libtsan.so"],
                             capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(tsan_rt):
        pytest.skip("libtsan runtime not available")
    cabac._build("tsan")
    env = dict(os.environ)
    env["HEVC_TPU_THREADS"] = "8"
    env["HEVC_TPU_LIB"] = os.path.join(NATIVE, "libhevc_entropy_tsan.so")
    env["OMP_NUM_THREADS"] = "1"  # keep torch's own pool out of shot
    env["LD_PRELOAD"] = tsan_rt
    env["TSAN_OPTIONS"] = ("halt_on_error=1 report_bugs=1 exitcode=66 "
                           "suppressions=" + os.path.join(NATIVE,
                                                          "tsan.supp"))
    out = subprocess.run([sys.executable, "-c", _WORKER, "1" if trace
                          else "0"], cwd=REPO, env=env, capture_output=True)
    assert out.returncode == 0, (out.returncode,
                                 out.stderr[-3000:].decode("utf8",
                                                           "replace"))
    assert len(out.stdout) > 1000
