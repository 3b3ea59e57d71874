"""EXPERIMENTS from the port's result files, the reference's
``benchmarks/report.py``: §Repro, the paper tables (``results/torch_{
uniform_sweep,perlayer_sweep,traffic,pareto_search,lm_precision}.json``);
§Dry-run and §Roofline, the dry run's per-rank counts and their roofline
bounds at the H100's data-sheet peaks (``results/torch_dryrun/<tag>/``,
``benchmarks.roofline``); §Perf, the perf loop's log
(``results/torch_perf_log.json``, ``benchmarks.perf``); and with
``--serve`` the serving trajectory's latest point against its first per
workload, from ``results/torch_BENCH_serve.json`` as the reference's
``serve_section`` reads its own record.

    python -m repro_torch.benchmarks.report [--write] [--serve]

``--write`` writes ``results/torch_EXPERIMENTS.md``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from ..configs.registry import ARCH_IDS, get_config
from ..configs.shapes import SHAPES, applicable
from . import common
from .pareto_search import PAPER_TR_1PCT
from .roofline import (CARD, HBM_BW, LINK_BW, PEAK_FLOPS, load_all,
                       records_dir, table)


def _load(name, default=None):
    try:
        return common.load_json(name)
    except FileNotFoundError:
        return default


def repro_section() -> str:
    out = ["## §Repro — paper-faithful reproduction", ""]
    uni = _load("uniform_sweep.json", {})
    per = _load("perlayer_sweep.json", {})
    par = _load("pareto_search.json", {})
    tra = _load("traffic.json", {})
    if uni:
        out += ["### Uniform precision across all layers (paper Fig. 2)", "",
                "| network | baseline top-1 | min weight frac bits @1% | "
                "min data int bits @1% | min data frac bits @1% |",
                "|---|---|---|---|---|"]
        for net, r in uni.items():
            out.append(f"| {net} | {r['baseline_accuracy']:.4f} | "
                       f"{r['min_weight_frac@1%']} | {r['min_data_int@1%']} "
                       f"| {r['min_data_frac@1%']} |")
        out += ["", "Paper's finding reproduced: ~10 weight bits / <=12 data "
                "int bits suffice uniformly; requirements differ per "
                "network.", ""]
    if per:
        out += ["### Per-layer tolerance (paper Fig. 3 — the key result)",
                "", "| network | per-layer min weight-frac bits @1% | "
                "spread (bits) |", "|---|---|---|"]
        for net, r in per.items():
            bits = [str(v["min_weight_frac@1%"])
                    for v in r["per_layer"].values()]
            out.append(f"| {net} | {'-'.join(bits)} | "
                       f"{r['weight_bits_spread']} |")
        out += ["", "Precision tolerance varies WITHIN each network "
                "(nonzero spread) — the paper's central observation.", ""]
    if tra:
        out += ["### Traffic accounting (paper Fig. 4)", "",
                "| network | single: W/D (M accesses) | batch: W/D | "
                "batch data-dominated |", "|---|---|---|---|"]
        for net, r in tra.get("cnn", {}).items():
            s, b = r["single"], r["batch"]
            out.append(
                f"| {net} | {s['weights_M']:.1f}/{s['data_M']:.1f} | "
                f"{b['weights_M']:.1f}/{b['data_M']:.1f} | "
                f"{r['data_dominate_batch']} |")
        out += [""]
    if par:
        out += ["### Greedy per-layer search (paper Fig. 5 / Table 2)", "",
                "| network | tol | traffic ratio (TR) | accuracy | paper "
                "TR@1% |", "|---|---|---|---|---|"]
        for net, r in par.items():
            for tol, t in r["tolerances"].items():
                ref = PAPER_TR_1PCT.get(net, "—") if tol == "1%" else ""
                out.append(f"| {net} | {tol} | {t['traffic_ratio']:.3f} | "
                           f"{t['accuracy']:.4f} | {ref} |")
        out += ["", "TR = priced traffic / 32-bit baseline. The search "
                "reproduces the paper's 3-10x traffic cuts at small "
                "accuracy loss; absolute TRs depend on our procedural "
                "datasets (easier than ImageNet => lower TR for the small "
                "nets, same qualitative band).", ""]
    lm = _load("lm_precision.json")
    if lm:
        out += ["### Beyond paper: same machinery on a transformer LM", "",
                f"arch={lm['arch']} baseline next-token top-1 = "
                f"{lm['baseline_topk1']:.4f}", ""]
        for tol, t in lm.get("tolerances", {}).items():
            out.append(f"- tol {tol}: TR={t['traffic_ratio']:.3f} "
                       f"acc={t['accuracy']:.4f}")
        out += [""]
    return "\n".join(out)


def dryrun_section(tag="baseline") -> str:
    rows = ["## §Dry-run — 512-rank multi-pod lay-out matrix", "",
            "Meshes: single pod (16,16) data x model = 256 ranks; "
            "multi-pod (2,16,16) pod x data x model = 512 ranks. Every "
            "applicable (arch x shape) cell lays out AND counts on both "
            "(`python -m repro_torch.launch.dryrun --arch all --shape all "
            "--mesh both`).", "",
            "| arch | shape | mesh | lay-out s | op flops/rank | HBM "
            "bytes/rank | wire bytes/rank | rank peak GiB |",
            "|---|---|---|---|---|---|---|---|"]
    n_ok = 0
    for path in sorted(glob.glob(os.path.join(records_dir(tag),
                                              "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("skipped"):
            continue
        n_ok += 1
        lc = rec["loop_cost"]
        gib = rec.get("memory", {}).get("peak_memory_in_bytes", 0) / 2**30
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
            f"{rec['lower_s']} | {lc['flops']:.2e} | "
            f"{lc['hbm_bytes']:.2e} | {lc['wire_bytes']:.2e} | {gib:.1f} |")
    cells = [applicable(get_config(a), s) for a in ARCH_IDS
             for s in SHAPES.values()]
    rows.insert(2, f"**{n_ok} cells laid out OK** ({sum(cells)} "
                   f"applicable cells x 2 meshes; {cells.count(False)} "
                   f"skips are principled — see configs.shapes."
                   f"applicable).")
    rows += ["", "Costs are per-rank-per-step from the op-level cost "
             "recorder (launch.hlo_cost), counted on fake tensors on the "
             "CPU: every op an eager step dispatches, each op's input and "
             "output bytes (an eager op is one launch), ring-model "
             "collective wire bytes. The recorder tracks live storages "
             "with in-place updates, so the peak is the per-rank fit the "
             "roofline reads.", ""]
    return "\n".join(rows)


def roofline_section(tag="baseline") -> str:
    recs = load_all(tag)
    out = ["## §Roofline — per (arch x shape), single pod (H100 "
           "constants)", "",
           f"compute = FLOPs/rank / {PEAK_FLOPS:.0e}; memory = HBM "
           f"bytes/rank / {HBM_BW:.0e}; collective = ring wire bytes/rank "
           f"/ {LINK_BW:.0e} (seconds/step): bounds at the {CARD} data "
           f"sheet's peaks, counted on the CPU, not measured.",
           "roofline frac = (MODEL_FLOPS/rank / peak) / max(term) — the "
           "fraction of peak the step-time lower bound achieves; "
           "useful/HLO = MODEL_FLOPS / counted FLOPs (recompute and "
           "redundant-rows overhead).", "",
           table(recs, mesh="single"), ""]
    sug = {}
    for r in recs:
        if r["mesh"] == "single":
            sug.setdefault(r["dominant"], []).append(
                f"{r['arch']}/{r['shape']}")
    out += ["### Dominant bottleneck per cell", ""]
    for dom, cells in sug.items():
        out.append(f"- **{dom}-bound**: {', '.join(cells)}")
    out += [""]
    return "\n".join(out)


def perf_section() -> str:
    log = _load("perf_log.json", [])
    out = ["## §Perf — hillclimb log (hypothesis -> change -> measure)", ""]
    if not log:
        out.append("(no perf iterations recorded yet)")
        return "\n".join(out)
    cur = None
    for e in log:
        cell = f"{e['arch']}/{e['shape']}"
        if cell != cur:
            out += [f"### {cell} ({e.get('why', '')})", ""]
            cur = cell
        out += [f"**[{e['iter']}] {e['title']}**",
                f"- hypothesis: {e['hypothesis']}",
                f"- change: {e['change']}",
                f"- before: {e['before']}",
                f"- after: {e['after']}",
                f"- verdict: {e['verdict']}", ""]
    return "\n".join(out)


# scalar fields worth trending, per workload result (a nested dict, as
# the mixed bench's per-row tokens_per_s, expands per sub-key)
_SERVE_METRICS = ("tokens_per_s", "goodput", "goodput_off", "goodput_delta",
                  "ttft_p99_s", "token_agreement", "program_reduction",
                  "prefill_forwards_reduction", "goodput_1rep",
                  "goodput_2rep", "token_agreement_2rep",
                  "blocked_speedup_geomean", "grid_step_ratio")


def _serve_points():
    """The trajectory grouped into (workload, fast) series. A mixed-bench
    point carries its metrics at the summary's top level (keyed by
    ``tokens_per_s``); a workload point nests them under the workload's
    name. An ``all`` point feeds both."""
    try:
        traj = json.loads(common.trajectory_path().read_text()).get(
            "trajectory", [])
    except (OSError, json.JSONDecodeError):
        return {}
    series = {}
    for p in traj:
        summary = p.get("summary") or {}
        items = []
        if "tokens_per_s" in summary:
            items.append(("mixed", summary))
        items += [(k, v) for k, v in summary.items()
                  if isinstance(v, dict) and k != "tokens_per_s"
                  and any(m in v for m in _SERVE_METRICS)]
        for wl, res in items:
            series.setdefault((wl, bool(p.get("fast"))), []).append(
                (p.get("when", "?"), res))
    return series


def _flat_metrics(res: dict) -> dict:
    out = {}
    for m in _SERVE_METRICS:
        if m not in res:
            continue
        v = res[m]
        if isinstance(v, dict):
            for k, vv in v.items():
                if isinstance(vv, (int, float)):
                    out[f"{m}[{k}]"] = float(vv)
        elif isinstance(v, (int, float)):
            out[m] = float(v)
        else:
            # present but not a number (an SLO field a run left None):
            # the row stays, as an explicit n/a
            out[m] = None
    return out


def _fmt_metric(v) -> str:
    return f"{v:.4g}" if isinstance(v, (int, float)) else "n/a"


def serve_section() -> str:
    series = _serve_points()
    out = ["## §Serve — torch_BENCH_serve.json trajectory "
           "(latest vs first, per workload)", ""]
    if not series:
        out.append("(no torch_BENCH_serve.json trajectory recorded yet)")
        return "\n".join(out)
    for (wl, fast), points in sorted(series.items()):
        first_when, first = points[0]
        last_when, last = points[-1]
        f0, f1 = _flat_metrics(first), _flat_metrics(last)
        label = f"{wl} ({'fast' if fast else 'full'}, {len(points)} point"
        label += "s)" if len(points) != 1 else ")"
        out += [f"### {label}",
                f"first {first_when} -> latest {last_when}", "",
                "| metric | first | latest | delta |", "|---|---|---|---|"]
        keys = [k for k in f1 if k in f0] \
            + [k for k in f1 if k not in f0] \
            + [k for k in f0 if k not in f1]
        for k in keys:
            v0, v1 = f0.get(k), f1.get(k)
            if isinstance(v0, float) and isinstance(v1, float):
                d = v1 - v0
                rel = f" ({d / abs(v0):+.1%})" if v0 else ""
                out.append(f"| {k} | {v0:.4g} | {v1:.4g} | "
                           f"{d:+.4g}{rel} |")
            elif k not in f0:
                out.append(f"| {k} | n/a | {_fmt_metric(v1)} | new |")
            else:
                out.append(f"| {k} | {_fmt_metric(v0)} | "
                           f"{_fmt_metric(v1)} | n/a |")
        out.append("")
    return "\n".join(out)


HEADER = """# EXPERIMENTS (the PyTorch port)

Reproduction of *Reduced-Precision Strategies for Bounded Memory in Deep
Neural Nets* (Judd et al., 2015) in the PyTorch port, and the port's
pod-scale dry run. The numbers regenerate via:

```
PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu
PYTHONPATH=src python -m repro_torch.benchmarks.report --write
```

The dry run's figures are counts on fake tensors on the CPU; its
roofline terms are bounds at the H100's data-sheet peaks, not times.
"""


def build(tag="baseline") -> str:
    return "\n".join([HEADER, repro_section(), dryrun_section(tag),
                      roofline_section(tag), perf_section()])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--write", action="store_true",
                    help="write results/torch_EXPERIMENTS.md")
    ap.add_argument("--serve", action="store_true",
                    help="print the serving trajectory's per-workload "
                         "latest-vs-first summary")
    args = ap.parse_args(argv)
    if args.serve:
        print(serve_section())
        return
    doc = build()
    if args.write:
        path = common.RESULTS / "torch_EXPERIMENTS.md"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(doc)
        print(f"wrote {path}")
    else:
        print(doc)


if __name__ == "__main__":
    main()
