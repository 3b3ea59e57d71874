"""A later change adds a cell, a traffic mix, a configuration or a metric by
adding files (and entries to ``BENCHMARK.json``), editing none: here, in a
copy of the benchmark, a new mix and cell on the serving configuration
and a new per-layer metric run on the CPU at test size."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
from bench import core
from bench.tests import smoke
spec = smoke.small(core.load_cell("qwen2-72b-x20.docqa-short"))
res = core.run_cell(spec, seed=7, seconds=0.8, trace=True, device="cpu")
print(json.dumps({"metrics": sorted(res["metrics"]),
                  "correct": res["correct"],
                  "doc_median": spec.mix["question"]["median"]}))
"""


def test_a_cell_mix_and_metric_added_as_files(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    # new files only
    mix = json.loads((tmp_path / "bench/traffic/docqa-shared.json")
                     .read_text())
    mix["about"] = "shorter questions"
    (tmp_path / "bench/traffic/docqa-short.json").write_text(json.dumps(mix))
    cell = json.loads((tmp_path / "bench/workloads/"
                       "qwen2-72b-x20.docqa-shared.json").read_text())
    cell["traffic"] = "docqa-short"
    (tmp_path / "bench/workloads/qwen2-72b-x20.docqa-short.json") \
        .write_text(json.dumps(cell))
    (tmp_path / "bench/metrics/answered_share.py").write_text(
        "def read(ctx):\n"
        "    if not ctx.get('attempted'):\n"
        "        return None\n"
        "    return 100.0 * (1 - ctx['failed'] / ctx['attempted'])\n")
    # and entries in BENCHMARK.json
    bench["workloads"].append({"name": "qwen2-72b-x20.docqa-short",
                               "config": "qwen2-72b-x20",
                               "traffic": "docqa-short", "chips": 1,
                               "why": "a test cell"})
    bench["per_layer"].append({"name": "answered_share", "unit": "%",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "Server loop and scheduler",
                               "moves": "tpot_p95_ms",
                               "workloads": ["qwen2-72b-x20.docqa-short"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "qwen2-72b-x20.docqa-shared" in m.get("workloads", []):
            m["workloads"].append("qwen2-72b-x20.docqa-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data     # nothing edited
    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path),
                          str(ROOT / "src")], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "answered_share" in got["metrics"]
    assert "live_rows_mean" in got["metrics"]
