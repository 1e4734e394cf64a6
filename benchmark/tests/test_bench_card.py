"""On a card: one short run of every cell through the command the
benchmark's checks use, correct and with its metrics."""
import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

from benchmark.harness import spec


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_runs_correct(trace, card):
    b = spec.benchmark()
    for w in b["workloads"]:
        out = subprocess.run(
            [sys.executable, os.path.join("benchmark", "run.py"),
             "--workload", w["name"], "--seed", str(2 ** 31 + 9),
             "--seconds", "3", "--trace", str(trace)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-4000:]
        r = json.loads(out.stdout.strip().splitlines()[-1])
        assert r["correct"] is True, out.stderr[-4000:]
        kind = "per_layer" if trace else "end_to_end"
        names = {m["name"] for m in spec.metrics_of(b, kind, w["name"])}
        assert set(r["metrics"]) <= names
        if not trace:
            assert set(r["metrics"]) == names
