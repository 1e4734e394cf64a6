"""Shared fixtures of the benchmark's own tests. Tests that need a card
carry the `cuda` marker and the `card` fixture, which decides whether a
card is present when the test runs (never while a module is imported)."""
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where none is present")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark directory with a tiny version of every
    traffic mix (`tiny.<mix>`), for CPU runs of the harness."""
    import json
    src = os.path.join(ROOT, "benchmark")
    dst = tmp_path / "benchmark"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "_cache", "tests"))
    for f in os.listdir(dst / "traffic"):
        mix = json.load(open(dst / "traffic" / f))
        mix["width"], mix["height"] = 192, 128
        json.dump(mix, open(dst / "traffic" / ("tiny." + f), "w"))
    return str(dst)


@pytest.fixture
def tiny_intra(tiny_bench):
    """(benchmark directory, cell) of a tiny all-intra cell that only the
    copy knows: the port's all-intra Main cfg (an IDR with POC 0 every
    picture), no searches, two warm-up pictures."""
    import json
    conf_dir = os.path.join(tiny_bench, "configs")
    shutil.copy(os.path.join(ROOT, "hevc_tpu_torch", "cfg",
                             "encoder_intra_main.cfg"),
                os.path.join(conf_dir, "intra_main.cfg"))
    with open(os.path.join(conf_dir, "ldp_main.json")) as fh:
        conf = json.load(fh)
    conf.update(name="intra_main", cfg="intra_main.cfg", warmup_pictures=2,
                searches=False, about="all-intra Main, QP 32")
    with open(os.path.join(conf_dir, "intra_main.json"), "w") as fh:
        json.dump(conf, fh)
    return tiny_bench, {"name": "intra_main.b1080_pan",
                        "config": "intra_main",
                        "traffic": "tiny.b1080_pan", "chips": 1}


def tiny_cell(name: str) -> dict:
    from benchmark.harness import spec
    cell = dict(spec.cell(spec.benchmark(), name))
    cell["traffic"] = "tiny." + cell["traffic"]
    return cell
