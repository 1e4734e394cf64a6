"""The command refuses to run without a card and without the encoder:
a non-zero exit and no result line."""
import os
import shutil
import subprocess
import sys

from conftest import ROOT


def test_no_result_with_only_the_benchmark_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ldp_main.b1080_pan", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
