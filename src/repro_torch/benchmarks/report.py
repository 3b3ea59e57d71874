"""The paper tables (§Repro) rendered from the port's result files
(``results/torch_{uniform_sweep,perlayer_sweep,traffic,pareto_search,
lm_precision}.json``),
as the reference's ``benchmarks/report.py::repro_section`` renders its own,
and (``--serve``) the serving trajectory's latest point against its first
per workload, from ``results/torch_BENCH_serve.json`` as the reference's
``serve_section`` reads its own record. The dry-run, roofline and perf
sections analyze XLA programs and wait for ROADMAP queue A item 13 part
5.

    python -m repro_torch.benchmarks.report [--serve]
"""
from __future__ import annotations

import argparse
import json

from . import common
from .pareto_search import PAPER_TR_1PCT


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--serve", action="store_true",
                    help="print the serving trajectory's per-workload "
                         "latest-vs-first summary")
    args = ap.parse_args(argv)
    print(serve_section() if args.serve else repro_section())


if __name__ == "__main__":
    main()
