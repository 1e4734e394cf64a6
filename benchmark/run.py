#!/usr/bin/env python3
"""Run one cell of the benchmark of hevc_tpu_torch on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Prints, as the last line of standard output,
one JSON object: `correct`, `attempted` (pictures coded in the window),
`failed` (of those, the ones whose bytes do not carry their
reconstruction's hash), `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `check`: each number compared with the reference beside its limit,
which also end standard error. Exits non-zero without a result when no
card is present, when the encoder is missing, or when a JAX module was
loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# kernel and build caches at fixed paths inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, "benchmark", "_cache", _sub)

from benchmark.harness import check, isolation, loop, spec  # noqa: E402


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def per_layer(bench: dict, cell_name: str, s, bench_dir: str) -> dict:
    ctx = {"pictures": s.pictures, "window_s": s.window_s,
           "t0": s.t0, "steps": s.steps, "sections": s.sections, "engine": s.engine,
           "profile": s.profile, "width": s.mix["width"],
           "height": s.mix["height"], "ctu": s.ctu,
           "search_range": s.search_range, "bit_depth": s.bit_depth}
    out = {}
    for m in spec.metrics_of(bench, "per_layer", cell_name):
        v = spec.metric_reader(m["name"], bench_dir)(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = spec.benchmark()
    cell = spec.cell(bench, a.workload)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    watts = power_limit_w()
    print(f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} "
          f"usable; card {torch.cuda.get_device_name(0)}, power limit "
          f"{watts} W", file=sys.stderr)
    rc, result = execute(bench, cell, a.seed, a.seconds, bool(a.trace),
                         watts=watts)
    if result is not None:
        print(json.dumps(result))
    return rc


def execute(bench: dict, cell: dict, seed: int, seconds: float,
            trace: bool, *, device: str = "cuda", watts=None,
            bench_dir: str = spec.BENCH_DIR, overrides=None):
    """Everything of a run after the look for a card: (exit code, result
    or None). Tests drive it on the CPU with device="cpu"."""
    s = loop.run(cell, seed, seconds, trace, t_start=T_START,
                 device=device, overrides=overrides, bench_dir=bench_dir)
    found = isolation.jax_modules()
    if found:
        print("JAX modules loaded by the run: " + ", ".join(found),
              file=sys.stderr)
        return 4, None
    name = cell["name"]
    numbers = check.evaluate(s)
    correct = all(numbers[k] <= lim for k, lim in check.LIMITS.items())
    if trace:
        metrics = per_layer(bench, name, s, bench_dir)
    else:
        e2e = check.end_to_end(s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_of(bench, "end_to_end", name)}
    if device == "cuda":
        import torch
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(0),
                       "count": cell["chips"],
                       "memory_peak_bytes": s.memory_peak,
                       "power_limit_w": watts}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": s.pictures,
              "failed": min(numbers["hash_mismatch"], s.pictures),
              "metrics": metrics, "device": device_info}
    if trace:
        from benchmark.harness import trace as tr
        red = s.profile
        device_info["busy_s"] = tr.busy_us(red["device"]) / 1e6
        device_info["window_s"] = (red["window_us"][1]
                                   - red["window_us"][0]) / 1e6
        result["breakdown"] = tr.breakdown(red)
    result["check"] = {k: {"value": v, "limit": check.LIMITS[k]}
                       for k, v in numbers.items()}
    d = s.decode
    print(f"checked {s.checked['searches']} sampled searches, "
          f"{s.checked['screens']} prescreens, {len(s.coded)} coded "
          f"pictures' hashes; decoded pictures {d['pocs']} (luma PSNR "
          + ", ".join(f"{v:.3f}" for v in d["psnr"].values())
          + "); skip and merge shares of their 4x4 blocks "
          + ", ".join(f"{k} {v:.4f}" for k, v in d["shares"].items()),
          file=sys.stderr)
    for note in s.notes[:20]:
        print("mismatch: " + note, file=sys.stderr)
    for k, v in numbers.items():
        print(f"check {k} {v} limit {check.LIMITS[k]}", file=sys.stderr)
    return 0, result


if __name__ == "__main__":
    sys.exit(main())
