"""The port's tracing: utils.timing's sections, loop spans, counters and
picture ids, and the CU engine's trace counters (entropy/native engine.h
namespace trace), on a 416x240 low-delay P encode with four wavefront
threads, plus one traced run of the benchmark harness on the CPU that
reads every per-layer metric of the program's trace.

Tracing never changes the stream; the engine's stages split its workers'
busy time exactly; loop spans never overlap a section or each other and
stay out of the sections' `total`."""
import contextlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from hevc_tpu_torch import runtime
from hevc_tpu_torch.entropy import cabac
from hevc_tpu_torch.utils import timing
from hevc_tpu_torch.utils.timing import timers
from test_torch_helpers import INTRA_CFG, LDP_CFG, REPO, moving_frames
from test_torch_helpers import one_torch_thread  # noqa: F401

W, H, N = 416, 240, 4
STAGES = ("engine_intra_s", "engine_merge_s", "engine_inter_search_s",
          "engine_residual_s", "engine_other_s")


def _encode(trace: bool, monkeypatch):
    """Code N pictures as the CLI and the benchmark drive the encoder (the
    next picture's lookahead, then the current picture) with the timers
    on or off. Returns the stream, the engine's counters of each frame
    call, the timers' records and the sizes of every upload."""
    from hevc_tpu_torch.encoder.top import EncoderTop
    from hevc_tpu_torch.io.cfg import parse_cli, validate
    monkeypatch.setenv("HEVC_TPU_THREADS", "4")
    calls, uploads = [], []
    frame = cabac.engine_encode_frame

    def counted(engine, ctus_w, ctus_h, fd):
        e0 = cabac.engine_frame_stats()
        frame(engine, ctus_w, ctus_h, fd)
        e1 = cabac.engine_frame_stats()
        calls.append({k: e1[k] - e0[k] for k in e0})
    monkeypatch.setattr(cabac, "engine_encode_frame", counted)
    upload = runtime.upload

    def sized(a, device):
        uploads.append(np.ascontiguousarray(a).nbytes)
        return upload(a, device)
    monkeypatch.setattr(runtime, "upload", sized)
    cfg = parse_cli(["-c", LDP_CFG, "-wdt", str(W), "-hgt", str(H),
                     "-f", str(N), "--SearchRange=16"])
    validate(cfg)
    frames = moving_frames(N, W, H)
    enc = EncoderTop(cfg, device="cpu")
    timers.reset()
    timers.enabled = trace
    try:
        out = []
        for i in range(N):
            if i + 1 < N:
                enc.prefetch_frame(frames[i + 1])
            out.append(enc.encode_frame(frames[i]))
        out.append(enc.flush())
    finally:
        timers.enabled = False
    rec = {"total": dict(timers.total), "loop": dict(timers.loop),
           "count": dict(timers.count), "events": list(timers.events),
           "pocs": [st["poc"] for st in enc.stats]}
    timers.reset()
    return b"".join(out), calls, rec, uploads


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        off = _encode(False, mp)
    with pytest.MonkeyPatch.context() as mp:
        on = _encode(True, mp)
    return {"off": off, "on": on}


def test_stream_identical_with_tracing_on_and_off(runs):
    assert len(runs["on"][0]) > 1000
    assert runs["on"][0] == runs["off"][0]


def test_engine_stages_sum_to_busy_in_every_call(runs):
    calls = runs["on"][1]
    assert len(calls) == N
    for c in calls:
        assert c["engine_traced_frames"] == 1
        assert c["engine_busy_s"] > 0
        # each stage is rounded to a nanosecond once per frame call
        assert abs(sum(c[k] for k in STAGES) - c["engine_busy_s"]) < 1e-8
    # off, the engine counts nothing but its wall and CPU time
    for c in runs["off"][1]:
        assert c["engine_traced_frames"] == 0
        assert c["engine_busy_s"] == 0 and c["engine_wait_s"] == 0
        assert c["engine_row_switches"] == 0


def test_engine_busy_and_wait_within_threads_times_wall(runs):
    calls = runs["on"][1]
    for c in calls:
        assert c["engine_busy_s"] + c["engine_wait_s"] \
            <= c["engine_thread_wall_s"] + 1e-9
        # four workers over the wall time of the frame call
        assert c["engine_thread_wall_s"] <= 4 * c["engine_wall_s"] + 1e-6
    # four workers over four CTU rows wait for ready CTUs
    assert sum(c["engine_wait_s"] for c in calls) > 0


def test_loop_spans_never_overlap_a_section_or_each_other(runs):
    rec = runs["on"][2]
    assert {"lookahead", "ref_prep", "frame_setup",
            "stream_write"} <= set(rec["loop"])
    events = sorted(rec["events"], key=lambda e: (e[1], e[2]))
    for a, b in zip(events, events[1:]):
        assert a[2] <= b[1], (a, b)
    # spans sum into loop and sections into total, never the other way
    assert not set(rec["loop"]) & set(rec["total"])
    for name, secs in rec["loop"].items():
        got = sum(t1 - t0 for n, t0, t1, _ in events if n == name)
        assert got == pytest.approx(secs)


def test_every_coded_picture_has_an_engine_host_event(runs):
    rec = runs["on"][2]
    pocs = {p for n, _, _, p in rec["events"] if n == "engine_host"}
    assert pocs == set(rec["pocs"]) == set(range(N))
    # the lookahead works for the next picture
    ahead = {p for n, _, _, p in rec["events"] if n == "lookahead"}
    assert ahead == set(range(1, N))


def test_lookahead_taken_within_searched(runs):
    count = runs["on"][2]["count"]
    assert 0 < count["me_lookahead_taken"] <= count["me_searched"]
    assert count["me_searched"] == N - 1


def test_intra_counters_read_nothing_with_tracing_off(runs):
    """Off, no intra counter and no engine count moves; on, the IDR (the
    one I picture, screened synchronously) counts once and its CUs take
    intra modes through full RD."""
    assert runs["off"][2]["count"] == {}
    assert all(c["engine_intra_rd_modes"] == 0 for c in runs["off"][1])
    count = runs["on"][2]["count"]
    assert count["intra_screened"] == 1
    assert count.get("intra_lookahead_taken", 0) == 0
    assert runs["on"][1][0]["engine_intra_rd_modes"] > 0


def _intra_engine_counts(w, h, planes, traced=True):
    """The engine's trace counts (ENGINE_TRACE_COUNTS of them: traced frame
    calls, row switches, intra modes through full RD, core transforms,
    exact RDOQs) over
    one all-intra picture of w x h, coded with tracing on or off."""
    from hevc_tpu_torch.encoder.top import EncoderTop
    from hevc_tpu_torch.io.cfg import parse_cli, validate
    cfg = parse_cli(["-c", INTRA_CFG, "-wdt", str(w), "-hgt", str(h),
                     "-f", "1"])
    validate(cfg)
    enc = EncoderTop(cfg, device="cpu")
    timers.reset()
    timers.enabled = traced
    try:
        e0 = cabac.engine_frame_stats()
        enc.encode_frame([np.ascontiguousarray(p) for p in planes])
        e1 = cabac.engine_frame_stats()
    finally:
        timers.enabled = False
        timers.reset()
    return {k: e1[k] - e0[k]
            for k in cabac.ENGINE_TRACE_KEYS[-cabac.ENGINE_TRACE_COUNTS:]}


def _intra_rd_modes(w, h, planes):
    """The engine's count of intra modes taken through full RD over one
    all-intra picture of w x h, coded with tracing on."""
    counts = _intra_engine_counts(w, h, planes)
    assert counts["engine_traced_frames"] == 1
    return counts["engine_intra_rd_modes"]


def test_engine_intra_rd_modes_grow_with_the_cus():
    """A 192x128 all-intra picture (six 64x64 CTUs) takes more intra modes
    through full RD than its own top-left 64x64 CTU coded alone."""
    y, u, v = moving_frames(1, 192, 128)[0]
    small = _intra_rd_modes(64, 64, [y[:64, :64], u[:32, :32], v[:32, :32]])
    big = _intra_rd_modes(192, 128, [y, u, v])
    assert 0 < small < big


@pytest.fixture(scope="module")
def intra_128x80_counts():
    """The engine's trace counts over one 128x80 all-intra picture, coded
    traced and untraced."""
    y, u, v = moving_frames(1, 128, 80)[0]
    return {traced: _intra_engine_counts(128, 80, [y, u, v], traced=traced)
            for traced in (True, False)}


def test_engine_xforms_count_only_while_traced(intra_128x80_counts):
    """A traced 128x80 all-intra picture counts its core transforms: each
    exact-RD mode trial transforms its residual, and so does every coded
    TB. Untraced, no engine count moves."""
    on = intra_128x80_counts[True]
    assert on["engine_traced_frames"] == 1
    assert on["engine_xforms"] > on["engine_intra_rd_modes"] > 0
    off = intra_128x80_counts[False]
    assert off == dict.fromkeys(off, 0)


def test_engine_rdoqs_count_only_while_traced(intra_128x80_counts):
    """A traced 128x80 all-intra picture counts its exact RDOQs: each
    exact-RD mode trial quantises its residual through rdoq_quant. Untraced
    the count stays 0."""
    on = intra_128x80_counts[True]
    assert on["engine_rdoqs"] > on["engine_intra_rd_modes"] > 0
    assert intra_128x80_counts[False]["engine_rdoqs"] == 0


def test_h2d_bytes_are_the_uploads_sizes(runs):
    count, uploads = runs["on"][2]["count"], runs["on"][3]
    assert count["h2d_bytes"] == sum(uploads) > 0
    # at least the source of every inter picture goes up
    assert count["h2d_bytes"] >= (N - 1) * W * H


class _Clock:
    """A perf_counter that moves only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _scripted(t, clock, spans: bool):
    """Sections and loop spans in the frame loop's pattern, each step of
    the clock a known time."""
    span = t.loop_span if spans else (
        lambda name, picture=None: contextlib.nullcontext())
    t.picture = 7
    with span("frame_setup"):
        clock.t += 1
        with t.section("me_device"):
            clock.t += 2
        with span("ref_prep"):
            clock.t += 4
        clock.t += 8
        with t.section("engine_host"):
            clock.t += 16
            with span("ref_prep"):      # inside a section: the section's
                clock.t += 32
    with span("lookahead", picture=8):
        clock.t += 64


def test_sections_total_same_with_and_without_loop_spans(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(timing.time, "perf_counter", clock)
    totals = {}
    for spans in (False, True):
        t = timing.Timers()
        t.enabled = True
        _scripted(t, clock, spans)
        totals[spans] = (dict(t.total), dict(t.loop), list(t.events))
    assert totals[True][0] == totals[False][0] == {"me_device": 2.0,
                                                   "engine_host": 48.0}
    assert totals[False][1] == {}
    assert totals[True][1] == {"frame_setup": 9.0, "ref_prep": 4.0,
                               "lookahead": 64.0}
    pics = {n: p for n, _, _, p in totals[True][2]}
    assert pics["engine_host"] == 7 and pics["lookahead"] == 8
    # disabled, nothing is recorded
    t = timing.Timers()
    _scripted(t, clock, True)
    t.add("h2d_bytes", 5)
    assert not t.total and not t.loop and not t.count and not t.events


def _tiny_bench(tmp_path):
    """The benchmark directory with 192x128 versions of its traffic."""
    dst = tmp_path / "benchmark"
    shutil.copytree(os.path.join(REPO, "benchmark"), dst,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    for f in os.listdir(dst / "traffic"):
        mix = json.load(open(dst / "traffic" / f))
        mix["width"], mix["height"] = 192, 128
        json.dump(mix, open(dst / "traffic" / ("tiny." + f), "w"))
    return str(dst)


# the per-layer metrics that read the program's trace, by the cell whose
# traced run on the CPU reads them (the all-intra cell's run is in
# test_torch_intra_main.py; intra_screen_roofline reads the device trace
# of the prescreen kernel and so reads nothing on the CPU)
_ENGINE_AND_LOOP = (
    "engine_wait_ms_per_frame", "engine_intra_ms_per_frame",
    "engine_residual_ms_per_frame", "engine_other_ms_per_frame",
    "engine_host_ms_p90", "lookahead_ms_per_frame",
    "frame_setup_ms_per_frame", "stream_write_ms_per_frame",
    "h2d_mb_per_frame", "engine_row_switches_per_frame",
    "engine_xforms_per_frame", "engine_rdoqs_per_frame")
TRACE_METRICS = {
    "ldp_main.e720_static": _ENGINE_AND_LOOP + (
        "engine_merge_ms_per_frame", "engine_inter_search_ms_per_frame",
        "ref_prep_ms_per_frame", "me_lookahead_hit_share"),
    "intra_main.b1080_pan": _ENGINE_AND_LOOP + (
        "intra_wait_ms_per_frame", "intra_lookahead_hit_share",
        "engine_intra_rd_modes_per_frame", "intra_screen_roofline"),
}


# one traced run of the harness on the CPU, in a process of its own (the
# harness refuses a run in a process where JAX is loaded, as it is here);
# argv: the benchmark directory. Prints the result as JSON.
_HARNESS = r"""
import json, sys
import torch
torch.set_num_threads(1)
from benchmark import run
from benchmark.harness import spec
bench = spec.benchmark()
cell = dict(spec.cell(bench, "ldp_main.e720_static"))
cell["traffic"] = "tiny." + cell["traffic"]
rc, result = run.execute(bench, cell, 2 ** 31 + 11, 2.0, True,
                         device="cpu", bench_dir=sys.argv[1],
                         overrides={"range_pictures": 4})
assert rc == 0, rc
print(json.dumps(result))
"""


def test_harness_trace_run_reads_every_trace_metric(tmp_path):
    """One traced run of the harness on the CPU (192x128, a 2-s window):
    every metric of the program's trace that the cell lists reads a
    number, and the loop spans name the idle time they cover."""
    from benchmark.harness import spec
    listed = {m["name"] for m in spec.metrics_of(
        spec.benchmark(), "per_layer", "ldp_main.e720_static")}
    names = TRACE_METRICS["ldp_main.e720_static"]
    assert set(names) <= listed
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _HARNESS,
                          _tiny_bench(tmp_path)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.splitlines()[-1])
    assert result["correct"] is True
    m = {k: v["value"] for k, v in result["metrics"].items()}
    for name in names:
        assert isinstance(m.get(name), float), name
    assert m["me_lookahead_hit_share"] > 0
    assert m["h2d_mb_per_frame"] >= 192 * 128 / 1e6
    names = {n for n, _ in result["breakdown"]["idle_gaps"]}
    assert {"lookahead", "ref_prep", "frame_setup"} <= names
