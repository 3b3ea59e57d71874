"""The import guard: no benchmark module loads JAX or the JAX package, and
the reference loads nothing of the program. Each check imports in a
fresh interpreter (the test process itself may hold JAX for other
tests) and compares whole top-level names: ``repro_torch`` begins with
``repro`` and is not it."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def _modules(sub=""):
    base = BENCH / sub if sub else BENCH
    out = []
    for p in sorted(base.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or p.name == "run.py" or "metrics" in rel.parts:
            continue
        out.append(".".join(rel.parts).removesuffix(".__init__"))
    return out


def _loaded_tops(code: str) -> set:
    prog = ("import sys, json\n"
            f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            + code +
            "\nprint(json.dumps(sorted({m.split('.', 1)[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_no_bench_module_loads_jax_or_the_jax_package():
    mods = _modules()
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in mods)
    code += ("from bench import core\n"
             "for m in core.benchmark()['end_to_end'] + "
             "core.benchmark()['per_layer']:\n"
             "    core.metric_reader(m['name'])\n")
    # the drivers' program imports are made inside their functions: load
    # what a run loads before its window
    code += ("import repro_torch.launch.serve, repro_torch.launch.steps, "
             "repro_torch.launch.train, repro_torch.models.attention\n")
    tops = _loaded_tops(code)
    bad = {"jax", "jaxlib", "flax", "repro"} & tops
    assert not bad, bad
    assert "repro_torch" in tops and "bench" in tops


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules("reference")
    assert len(mods) >= 3
    tops = _loaded_tops("import importlib\n" + "".join(
        f"importlib.import_module({m!r})\n" for m in mods))
    assert not {"repro_torch", "repro", "jax"} & tops


def test_forbidden_names_compare_whole():
    from bench import core
    saved = dict(sys.modules)
    try:
        for k in [m for m in sys.modules
                  if m.split(".", 1)[0] in core.FORBIDDEN]:
            del sys.modules[k]
        sys.modules.setdefault("repro_torch", sys.modules.get("bench"))
        assert core.forbidden_loaded() == []
        sys.modules["repro"] = sys.modules["bench"]
        assert core.forbidden_loaded() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


@pytest.mark.parametrize("missing", ["src", "cards"])
def test_run_refuses_without_the_program_or_the_cards(tmp_path, missing):
    """In a checkout holding only BENCHMARK.json and bench/ (no program),
    or on a machine without a card, run.py exits non-zero and prints no
    result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if missing == "cards":
        shutil.copytree(ROOT / "src", tmp_path / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "qwen2-72b-x20.docqa-shared", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=240, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not any(l.startswith("{") for l in out.stdout.splitlines())
