"""hevc_tpu_torch stands alone: no file of the package, and not
chip_smoke.py, imports jax or hevc_tpu (the machine with the card has no
JAX), and the package encodes with jax made unimportable."""
import ast
import os
import subprocess
import sys

import pytest

from test_torch_helpers import REPO

FORBIDDEN = ("jax", "jaxlib", "hevc_tpu")


def _sources():
    pkg = os.path.join(REPO, "hevc_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_sources_exist():
    files = _sources()
    assert os.path.join(REPO, "chip_smoke.py") in files
    assert len(files) > 30
    for rel in ("decoder/top.py", "decoder/recon.py", "decoder/headers.py",
                "entropy/bitreader.py", "cli/decode.py", "ops/intra_screen.py"):
        assert os.path.join(REPO, "hevc_tpu_torch", rel) in files


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_encodes_with_jax_unimportable(tmp_path):
    script = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
sys.path.insert(0, {REPO!r})
import numpy as np
from hevc_tpu_torch.cli.encode import main
w, h, n = 64, 64, 2
rng = np.random.default_rng(1)
with open({str(tmp_path / 'c.yuv')!r}, "wb") as fh:
    for t in range(n):
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        fh.write(y.tobytes() + y[::2, ::2].tobytes() + y[1::2, ::2].tobytes())
rc = main(["-c", {os.path.join(REPO, 'hevc_tpu_torch', 'cfg',
                                'encoder_lowdelay_P_main.cfg')!r},
           "-i", {str(tmp_path / 'c.yuv')!r}, "-wdt", "64", "-hgt", "64",
           "-f", "2", "-b", {str(tmp_path / 'o.bin')!r}], device="cpu")
assert rc == 0
assert not [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}
            and sys.modules[m] is not None]
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().endswith("OK")
    assert (tmp_path / "o.bin").stat().st_size > 0


def test_decodes_with_jax_unimportable(tmp_path):
    """An all-intra encode and its decode by the port's CLI, with jax and
    hevc_tpu made unimportable: every picture hash checks."""
    script = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
sys.path.insert(0, {REPO!r})
import numpy as np
from hevc_tpu_torch.cli.decode import main as decode
from hevc_tpu_torch.cli.encode import main as encode
w, h, n = 64, 48, 2
rng = np.random.default_rng(2)
with open({str(tmp_path / 'c.yuv')!r}, "wb") as fh:
    for t in range(n):
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        fh.write(y.tobytes() + y[::2, ::2].tobytes() + y[1::2, ::2].tobytes())
assert encode(["-c", {os.path.join(REPO, 'hevc_tpu_torch', 'cfg',
                                   'encoder_intra_main.cfg')!r},
               "-i", {str(tmp_path / 'c.yuv')!r}, "-wdt", "64", "-hgt", "48",
               "-f", "2", "-b", {str(tmp_path / 'o.bin')!r}],
              device="cpu") == 0
assert decode(["-b", {str(tmp_path / 'o.bin')!r}, "-o",
               {str(tmp_path / 'd.yuv')!r}]) == 0
assert not [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}
            and sys.modules[m] is not None]
print("OK")
"""
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[hash OK]") == 2
    assert r.stdout.strip().endswith("OK")
    assert (tmp_path / "d.yuv").stat().st_size == 2 * 64 * 48 * 3 // 2
