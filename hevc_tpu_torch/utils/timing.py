"""Per-stage wall-clock timers, loop spans and counters of the encoder.

Parity: the reference's only profiling is a clock() around the slice
encode printed as `[ET ..]` (TEncGOP.cpp:1052,2124). Here every pipeline
stage (device ME, native engine, entropy coding, loop filters) reports
separately so the device/host split is visible; the benchmark
(benchmark/harness/loop.py) enables the timers for its traced window and
its per-layer metrics read them afterwards.

Three kinds of record, all on the `time.perf_counter` clock:

- `section(name)`: a pipeline stage. Sections are disjoint and sum into
  `total` (and `count`).
- `loop_span(name)`: a named part of the frame loop's own time (the
  lookahead, reference preparation, frame set-up, stream writing). A loop
  span sums into `loop`, never into `total`, and never overlaps a section
  or another loop span: a section or loop span opened inside it pauses
  it until that one ends, and a loop span opened inside a section is
  part of the section. Each piece of a loop span is also a
  `record_function("section.<name>")` range, so a profiler trace names
  the time it covers.
- `add(name, n)`: a counter, into `count`.

Every section and loop-span piece is kept in `events` as (name, t0, t1,
picture): `picture` is the display POC of the picture the work is for
(`picture`, which the encoder sets; a loop span may name another, as the
lookahead names the next picture). `reset()` clears everything.

Timers are disabled by default; disabled, each call costs one branch.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

SPAN_PREFIX = "section."


class _Span:
    __slots__ = ("name", "picture", "t0", "rf")

    def __init__(self, name, picture):
        self.name, self.picture = name, picture
        self.t0 = self.rf = None


class Timers:
    def __init__(self):
        self.total = defaultdict(float)
        self.loop = defaultdict(float)
        self.count = defaultdict(int)
        self.events = []
        self.picture = None
        self.enabled = False
        self._open = []          # open loop spans, innermost last
        self._depth = 0          # open sections

    @contextlib.contextmanager
    def section(self, name: str):
        if not self.enabled:
            yield
            return
        self._pause()
        self._depth += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._depth -= 1
            self.total[name] += t1 - t0
            self.count[name] += 1
            self.events.append((name, t0, t1, self.picture))
            self._resume()

    @contextlib.contextmanager
    def loop_span(self, name: str, picture=None):
        if not self.enabled or self._depth:
            yield
            return
        self._pause()
        span = _Span(name, self.picture if picture is None else picture)
        self._open.append(span)
        self._start(span)
        try:
            yield
        finally:
            self._stop(span)
            self._open.pop()
            self._resume()

    def add(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self.count[name] += n

    def reset(self) -> None:
        self.total.clear()
        self.loop.clear()
        self.count.clear()
        self.events.clear()

    def _start(self, span) -> None:
        from torch.autograd.profiler import record_function
        span.rf = record_function(SPAN_PREFIX + span.name)
        span.rf.__enter__()
        span.t0 = time.perf_counter()

    def _stop(self, span) -> None:
        t1 = time.perf_counter()
        span.rf.__exit__(None, None, None)
        span.rf = None
        self.loop[span.name] += t1 - span.t0
        self.events.append((span.name, span.t0, t1, span.picture))

    def _pause(self) -> None:
        if self._open and not self._depth:
            self._stop(self._open[-1])

    def _resume(self) -> None:
        if self._open and not self._depth:
            self._start(self._open[-1])


timers = Timers()
