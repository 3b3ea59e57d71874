"""Import guard: the PyTorch port and chip_smoke.py stand without JAX and
without the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any "import jax" now raises
sys.modules["repro"] = None        # and so does the JAX package
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print("IMPORTED", len(names))
"""


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT, str(ROOT / "src"), str(ROOT)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    n = int(res.stdout.split("IMPORTED")[1])
    assert n >= len(list(PORT.rglob("*.py"))) - 1   # every module but root


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+jax\b",
    r"^\s*from\s+repro(\.|\s+import)",
    r"^\s*import\s+repro(\.|\s|$)"])
def test_no_source_names_jax_or_the_jax_package(pattern):
    rx = re.compile(pattern, re.M)
    hits = [str(p.relative_to(ROOT)) for p in _sources()
            if rx.search(p.read_text())]
    assert not hits, hits


_SLICE_MODULES = ["repro_torch.core.fixedpoint", "repro_torch.core.qtensor",
                  "repro_torch.kernels.ref", "repro_torch.kernels.quant_cast",
                  "repro_torch.kernels.pack",
                  "repro_torch.kernels.quant_matmul",
                  "repro_torch.kernels.paged_kv_attention",
                  "repro_torch.kernels.kv_attention",
                  "repro_torch.kernels.ops", "repro_torch.kernels.build",
                  "repro_torch.quant.apply",
                  "repro_torch.benchmarks.kernel_bench"]


def test_kernel_entry_point_modules_import_without_jax():
    """Each module of the kernel entry point, named one by one, imports
    with jax and the JAX package blocked."""
    script = ("import importlib, sys\n"
              "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
              "sys.path.insert(0, sys.argv[1])\n"
              "for name in sys.argv[2:]:\n"
              "    importlib.import_module(name)\n"
              "print('OK', len(sys.argv) - 2)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", script, str(ROOT / "src"),
                          *_SLICE_MODULES], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.split() == ["OK", str(len(_SLICE_MODULES))]
