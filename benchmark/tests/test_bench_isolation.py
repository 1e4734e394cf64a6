"""Neither the harness nor its reference loads JAX or the JAX package:
module names are compared whole, by their part before the first dot."""
import ast
import os
import subprocess
import sys

from conftest import ROOT

from benchmark.harness import isolation


def test_names_compared_whole():
    mods = ["hevc_tpu_torch", "hevc_tpu_torch.ops.me_ssd", "jaxtyping",
            "numpy", "flaxen"]
    assert isolation.jax_modules(mods) == []
    assert isolation.jax_modules(mods + ["jax.numpy"]) == ["jax"]
    assert isolation.jax_modules(["hevc_tpu.ops", "jaxlib"]) == [
        "hevc_tpu", "jaxlib"]


def test_sources_import_no_jax():
    bdir = os.path.join(ROOT, "benchmark")
    for dirpath, _, files in os.walk(bdir):
        if "tests" in dirpath.split(os.sep):
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                for n in names:
                    assert isolation.top_level(n) not in \
                        isolation.FORBIDDEN, (f, n)


def test_run_and_reference_load_no_jax():
    code = (
        "import sys; sys.argv = ['x']\n"
        "import runpy\n"
        "runpy.run_path('benchmark/run.py', run_name='not_main')\n"
        "import benchmark.harness.reference, benchmark.harness.loop\n"
        "import benchmark.harness.check, benchmark.harness.trace\n"
        "import hevc_tpu_torch.encoder.top\n"
        "from benchmark.harness import isolation\n"
        "print(isolation.jax_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_and_decoder_load_nothing_of_the_program():
    code = (
        "import sys\n"
        "import benchmark.harness.reference, benchmark.harness.decode\n"
        "import benchmark.hevcdec.decoder.top\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'hevc_tpu_torch', 'hevc_tpu', 'jax', 'jaxlib'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
