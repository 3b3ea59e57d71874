"""What every cell shares: finding a cell's files by name, the window
arithmetic (nearest-rank percentiles, rates), the metric readers, the
import guard and the result line.

A cell ``<config>.<traffic>`` is ``workloads/<cell>.json``; it names its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and its driver (``drivers/<driver>.py``,
whose ``run(spec, seed, seconds, trace)`` returns a context dict). Each
metric of ``BENCHMARK.json`` is ``metrics/<name>.py``, whose
``read(ctx)`` returns a number or None (nothing to read: the metric is
left out). Adding a cell, a mix, a configuration or a metric is adding
files.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no benchmark process may hold: the JAX
# package and JAX itself (compared whole: ``repro_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class CellSpec:
    """A cell's files, loaded: the cell, its configuration, its mix, and
    its entries of ``BENCHMARK.json``."""

    name: str
    cell: dict
    config: dict
    mix: dict
    metrics: List[dict]        # every metric of BENCHMARK.json
    # the tools' and tests' changes to a run (a control's precision, a
    # rate); the benchmark's own runs have none
    overrides: dict = dataclasses.field(default_factory=dict)

    def metrics_for(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: its end-to-end ones (trace off)
        or its per-layer ones (trace on)."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.metrics if m["_kind"] == key
                and ("workloads" not in m or self.name in m["workloads"])]


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_cell(name: str) -> CellSpec:
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(BENCH / "workloads" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    mix = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    metrics = ([dict(m, _kind="end_to_end") for m in bench["end_to_end"]]
               + [dict(m, _kind="per_layer") for m in bench["per_layer"]])
    return CellSpec(name=name, cell=dict(cell, chips=entry["chips"]),
                    config=config, mix=mix, metrics=metrics)


def driver(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# Window arithmetic
# ---------------------------------------------------------------------------
def nearest_rank(values: Sequence[Optional[float]], q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of ``values``; a None
    (a request that failed or never answered) counts as larger than any
    number, so it can be the quantile (then inf)."""
    if not values:
        return math.nan
    xs = sorted(math.inf if v is None else v for v in values)
    return xs[max(1, math.ceil(q * len(xs))) - 1]


def process_start_time() -> float:
    """This process's start on the ``time.time()`` clock (Linux: read
    from /proc), else the time this module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_loaded() -> List[str]:
    """Whole top-level names of ``FORBIDDEN`` present in sys.modules."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(n for n in FORBIDDEN if n in tops)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------
def run_cell(spec: CellSpec, *, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> dict:
    """Drive one cell once and return the result line's object (without
    printing it). ``device`` "cpu" runs the CPU path at whatever size the
    spec holds (tests only)."""
    ctx = driver(spec.cell["driver"]).run(spec, seed=seed, seconds=seconds,
                                          trace=trace, device=device)
    metrics = {}
    for m in spec.metrics_for(trace):
        v = metric_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": bool(ctx["correct"]), "attempted": int(ctx["attempted"]),
           "failed": int(ctx["failed"]), "metrics": metrics,
           "device": ctx["device"]}
    if trace and ctx.get("breakdown"):
        out["breakdown"] = ctx["breakdown"]
    out["notes"] = {k: v for k, v in ctx.items()
                    if k in ("notes", "sample") or k.startswith("control")}
    out["checks"] = ctx["checks"]
    return out


def check_lines(checks: Dict[str, dict]) -> List[str]:
    """One line per number compared: its value beside its limit."""
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r}, "
            f"{'ok' if c['ok'] else 'FAILED'})" for k, c in checks.items()]


def device_block(device: str) -> dict:
    """The result's ``device``: one card, its name and its peak memory
    (read once the window has closed, before the reference runs)."""
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
