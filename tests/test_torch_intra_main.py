"""All-intra Main (the benchmark's `intra_main` configuration): every
picture is coded with the prescreen of its own source, whatever order the
caller prefetches in, and the harness runs the committed configuration on
the CPU at 192x128: `correct`, its control failing, and a traced run that
reads the intra path's spans and counters.

The prefetch orders: none (each picture screened synchronously), the
harness's (`prefetch_frame(N+1)` just before `encode_frame(N)`; picture 0
never prefetched) and the CLI's (each picture prefetched as it is read,
three ahead of the one coded)."""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark.harness import spec
from benchmark.harness.traffic import Stream
from hevc_tpu_torch.cli import encode as cli_encode
from hevc_tpu_torch.encoder.top import EncoderTop
from hevc_tpu_torch.entropy import cabac
from hevc_tpu_torch.io.cfg import parse_cli, validate
from hevc_tpu_torch.ops import intra_screen
from test_torch_helpers import INTRA_CFG, REPO
from test_torch_helpers import one_torch_thread  # noqa: F401
from test_torch_tracing import TRACE_METRICS, _tiny_bench

W, H, N = 128, 80, 5
CELL = "intra_main.b1080_pan"


def _sources():
    """N pictures of the cell's traffic mix at 128x80 (int16 8-bit planes,
    as the harness hands them over)."""
    mix = dict(spec.traffic("b1080_pan"), width=W, height=H)
    stream = Stream(mix, 7)
    return [stream.next() for _ in range(N)]


def _spy_hints(monkeypatch) -> list:
    """Record the prescreen every engine is given, in coding order."""
    hints = []
    real = cabac.NativeCtuEngine.set_intra_hints

    def spy(self, h):
        hints.append(h)
        return real(self, h)
    monkeypatch.setattr(cabac.NativeCtuEngine, "set_intra_hints", spy)
    return hints


def _encode(order, frames, tmp_path):
    if order == "cli":
        src = tmp_path / "in.yuv"
        out = tmp_path / "out.bin"
        with open(src, "wb") as fh:
            for planes in frames:
                for p in planes:
                    fh.write(np.asarray(p, np.uint8).tobytes())
        rc = cli_encode.main(["-c", INTRA_CFG, "-i", str(src), "-wdt",
                              str(W), "-hgt", str(H), "-f", str(N), "-b",
                              str(out)], device="cpu")
        assert rc == 0
        return out.read_bytes()
    cfg = parse_cli(["-c", INTRA_CFG, "-wdt", str(W), "-hgt", str(H),
                     "-f", str(N)])
    validate(cfg)
    enc = EncoderTop(cfg, device="cpu")
    chunks = []
    for i, planes in enumerate(frames):
        if order == "harness" and i + 1 < N:
            enc.prefetch_frame(frames[i + 1])
        chunks.append(enc.encode_frame(planes))
    chunks.append(enc.flush())
    return b"".join(chunks)


@pytest.fixture(scope="module")
def encodes(tmp_path_factory):
    """{order: (stream, the screens the engines were given)}."""
    frames = _sources()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for order in ("none", "harness", "cli"):
            hints = _spy_hints(mp)
            data = _encode(order, frames, tmp_path_factory.mktemp(order))
            out[order] = (data, hints)
            mp.undo()
    return frames, out


@pytest.mark.parametrize("order", ["harness", "cli"])
def test_all_intra_stream_same_in_every_prefetch_order(encodes, order):
    _, out = encodes
    assert len(out["none"][0]) > 1000
    assert out[order][0] == out["none"][0]


@pytest.mark.parametrize("order", ["none", "harness", "cli"])
def test_each_picture_coded_with_its_own_screen(encodes, order):
    """Each coded picture's candidate lists and best costs are those of
    `screen_frame` on its own source, at the picture's lambda."""
    frames, out = encodes
    hints = out[order][1]
    assert len(hints) == N
    sqrt_lam = math.sqrt(0.57 * 2.0 ** ((32 - 12) / 3.0))
    for i, (got, planes) in enumerate(zip(hints, frames)):
        want = intra_screen.screen_frame(planes[0], 8, sqrt_lam,
                                         device="cpu")
        assert sorted(got) == sorted(want)
        for log2, (cands, costs) in want.items():
            assert np.array_equal(got[log2][0], cands), (i, log2)
            assert np.array_equal(got[log2][1], costs), (i, log2)


def test_prefetched_screen_of_a_coded_picture_is_dropped():
    """A screen prefetched for a picture that is coded before it arrives
    is dropped; the next picture still takes its own."""
    cfg = parse_cli(["-c", INTRA_CFG, "-wdt", str(W), "-hgt", str(H),
                     "-f", str(N)])
    validate(cfg)
    frames = _sources()
    enc = EncoderTop(cfg, device="cpu")
    enc.prefetch_frame(frames[0], picture=0)
    enc.prefetch_frame(frames[2], picture=2)
    enc.prefetch_frame(frames[1])           # the default: picture 1
    assert sorted(enc._intra_screens) == [0, 1, 2]
    enc.encode_frame(frames[0])
    enc.encode_frame(frames[1])
    assert sorted(enc._intra_screens) == [2]
    enc.prefetch_frame(frames[1], picture=1)  # too late for picture 1
    enc.encode_frame(frames[2])
    assert enc._intra_screens == {}


# runs of the committed intra_main configuration on the tiny version of
# its traffic, in a process of their own (the harness refuses a process in
# which JAX is loaded); argv: the benchmark directory. Prints one JSON
# object: the untraced run's result, what it decoded, its notes
# and its control's numbers, and the traced run's result.
_RUNS = r"""
import json, sys
import torch
torch.set_num_threads(1)
from benchmark import run
from benchmark.harness import check, loop, spec
kept = []
plain = loop.run
def keep(*a, **k):
    kept.append(plain(*a, **k))
    return kept[-1]
loop.run = keep
bench = spec.benchmark()
cell = dict(spec.cell(bench, "intra_main.b1080_pan"))
cell["traffic"] = "tiny." + cell["traffic"]
rc, plain_run = run.execute(bench, cell, 2 ** 31 + 57, 1.0, False,
                            device="cpu", bench_dir=sys.argv[1])
assert rc == 0, rc
s = kept[-1]
psnr = sorted(s.decode["psnr"])
notes = list(s.notes)
control = check.evaluate(s, drop_bits=int(s.conf["control_drop_bits"]))
rc, traced = run.execute(bench, cell, 2 ** 31 + 59, 1.0, True,
                         device="cpu", bench_dir=sys.argv[1],
                         overrides={"range_pictures": 4})
assert rc == 0, rc
print(json.dumps({"plain": plain_run, "psnr": psnr, "notes": notes,
                  "range": len(s.range), "control": control,
                  "traced": traced}))
"""


@pytest.fixture(scope="module")
def harness_runs(tmp_path_factory):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _RUNS,
                          _tiny_bench(tmp_path_factory.mktemp("bench"))],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


def test_committed_configuration_is_correct_and_its_control_fails(
        harness_runs):
    """The committed configuration (its 32-picture bits range) through
    `run.execute`: every count 0, the first IDR and one sampled picture
    decoded, and the reference at 4 bits failing every count but the
    searches (there are none)."""
    r = harness_runs
    assert r["range"] == 32
    assert r["plain"]["correct"] is True, r
    assert all(v["value"] == 0 for v in r["plain"]["check"].values())
    assert len(r["psnr"]) == 2
    assert not any("not decoded" in n for n in r["notes"]), r["notes"]
    assert {"fps", "kbit_per_frame", "psnr_y_db",
            "setup_s"} <= set(r["plain"]["metrics"])
    c = r["control"]
    assert c["hash_mismatch"] > 0 and c["decode_mismatch"] > 0
    assert c["screen_mismatch"] > 0 and c["search_mismatch"] == 0


def test_traced_run_reads_the_intra_metrics(harness_runs):
    """Every metric of the program's trace that the cell lists reads a
    number, except the kernel's roofline, which has no kernel on the CPU;
    every picture of the window took its screen from the lookahead."""
    listed = {m["name"] for m in spec.metrics_of(spec.benchmark(),
                                                 "per_layer", CELL)}
    names = TRACE_METRICS[CELL]
    assert set(names) <= listed
    t = harness_runs["traced"]
    assert t["correct"] is True
    m = {k: v["value"] for k, v in t["metrics"].items()}
    for name in names:
        if name == "intra_screen_roofline":
            assert name not in m
        else:
            assert isinstance(m.get(name), float), name
    assert m["intra_lookahead_hit_share"] == 100.0
    assert m["engine_intra_rd_modes_per_frame"] > 0
    assert m["intra_wait_ms_per_frame"] >= 0
    # the inter path's metrics stay out of the cell
    assert not {"me_lookahead_hit_share", "me_wait_ms_per_frame",
                "ref_prep_ms_per_frame"} & set(m)
