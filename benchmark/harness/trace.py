"""The traced run's readings: host sections as spans, the device's
activity from torch.profiler, and their reduction to what the per-layer
metrics and the result's `breakdown` read.

The encoder's `utils.timing` sections are the host spans: while tracing,
`spans_on` wraps the section context of the encoder's `timers` so that
each section is also a `record_function` range in the profiler's clock.
Device intervals are the profiler's CUDA activity (kernels and copies)."""
from __future__ import annotations

import bisect
import contextlib
import re

WINDOW_SPAN = "bench.window"
SECTION_PREFIX = "section."


def spans_on(timers):
    """Make every `timers.section(name)` a profiler range too. Returns the
    function that undoes it."""
    from torch.autograd.profiler import record_function
    plain = timers.section

    @contextlib.contextmanager
    def section(name):
        with record_function(SECTION_PREFIX + name), plain(name):
            yield

    timers.section = section

    def undo():
        timers.section = plain
    return undo


def short_name(name: str) -> str:
    n = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return n.split("(")[0][:96]


def merge(intervals):
    """Sorted, disjoint union of [start, end) intervals."""
    out = []
    for st, en in sorted(intervals):
        if out and st <= out[-1][1]:
            if en > out[-1][1]:
                out[-1][1] = en
        else:
            out.append([st, en])
    return out


def reduce_profile(prof) -> dict:
    """{window_us: (start, end), device: [(name, start, end)] inside the
    window (microseconds), sections: [(name, start, end)]}."""
    from torch.autograd import DeviceType
    window = None
    device, sections = [], []
    for e in prof.events():
        tr = e.time_range
        ours = e.name == WINDOW_SPAN or e.name.startswith(SECTION_PREFIX)
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors record_function ranges onto the
            # device's timeline as annotations: they are no device work
            if not ours:
                device.append((short_name(e.name), tr.start, tr.end))
        elif e.name == WINDOW_SPAN:
            window = (tr.start, tr.end)
        elif e.name.startswith(SECTION_PREFIX):
            sections.append((e.name[len(SECTION_PREFIX):], tr.start,
                             tr.end))
    if window is not None:
        a, b = window
        device = [(n, max(s, a), min(t, b)) for n, s, t in device
                  if t > a and s < b]
    return {"window_us": window, "device": device, "sections": sections}


def busy_us(device) -> float:
    return sum(b - a for a, b in merge([(s, t) for _, s, t in device]))


def breakdown(red: dict) -> dict:
    """The ten device operations that took most time, and the idle time of
    the device summed by the host section that ran through it ("loop":
    none), both in seconds."""
    by_op = {}
    for n, s, t in red["device"]:
        by_op[n] = by_op.get(n, 0.0) + (t - s) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    a, b = red["window_us"]
    busy = merge([(s, t) for _, s, t in red["device"]])
    gaps, cur = [], a
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if b > cur:
        gaps.append((cur, b))
    secs = sorted(red["sections"], key=lambda x: x[1])
    starts = [s for _, s, _ in secs]
    idle = {}
    for g0, g1 in gaps:
        # split each gap by the sections that overlap it
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        covered = 0.0
        while i < len(secs) and secs[i][1] < g1:
            n, s, t = secs[i]
            ov = min(t, g1) - max(s, g0)
            if ov > 0:
                idle[n] = idle.get(n, 0.0) + ov / 1e6
                covered += ov
            i += 1
        rest = (g1 - g0) - covered
        if rest > 0:
            idle["loop"] = idle.get("loop", 0.0) + rest / 1e6
    gaps_out = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps_out]}


def kernel_events(red: dict, pattern: str):
    """[(match, seconds)] of the device events whose name matches."""
    rx = re.compile(pattern)
    out = []
    for n, s, t in red["device"]:
        m = rx.search(n)
        if m:
            out.append((m, (t - s) / 1e6))
    return out
