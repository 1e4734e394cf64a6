"""Finding a cell's parts by the names BENCHMARK.json gives them.

A cell names a configuration (benchmark/configs/<name>.json) and a traffic
mix (benchmark/traffic/<name>.json); a per-layer metric is read by
benchmark/metrics/<name>.py. Nothing here knows any cell by name: a later
change adds a cell, a configuration, a mix or a metric by adding files and
entries."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def config(name: str, bench_dir: str = BENCH_DIR) -> dict:
    c = load_json(os.path.join(bench_dir, "configs", name + ".json"))
    c["cfg_path"] = os.path.join(bench_dir, "configs", c["cfg"])
    return c


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "traffic", name + ".json"))


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The `read(ctx)` function of benchmark/metrics/<name>.py. A name
    split by the end-to-end metric it moves (`<base>.<suffix>`) is read
    by <base>.py where no file of its own exists."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(bench_dir, "metrics",
                            name.split(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, kind: str, cell_name: str) -> list:
    """The `end_to_end` or `per_layer` entries that this cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
