#!/usr/bin/env python3
"""Readings of the comparison that decides `correct`, for the program and
for its control, on several seeds of one cell in one process:

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 5

The control is the reference put in the program's place at the nearest
lower sample precision (the configuration's `control_drop_bits` low bits
cleared: 8-bit samples at 4 bits, 10-bit ones at 8): the benchmark's
decoder keeping every sample, its references' too, at that precision
(its pictures set against the program's reconstructions and the
stream's hash SEI), and the window's searches and prescreens computed
from samples at that precision. One JSON line a seed. Not part of a
benchmark run; needs a card."""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import check, loop, spec  # noqa: E402


def readings(cell: dict, seed: int, seconds: float, device: str = "cuda",
             bench_dir: str = spec.BENCH_DIR, overrides=None) -> dict:
    s = loop.run(cell, seed, seconds, False, t_start=time.perf_counter(),
                 device=device, overrides=overrides, bench_dir=bench_dir)
    program = check.evaluate(s)
    notes = list(s.notes)
    control = check.evaluate(s, int(s.conf["control_drop_bits"]))
    return {"seed": seed, "pictures": s.pictures, "checked": s.checked,
            "program": program, "control": control, "notes": notes[:5]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = spec.cell(spec.benchmark(), a.workload)
    for seed in (int(x) for x in a.seeds.split(",")):
        print(json.dumps(readings(cell, seed, a.seconds)), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
