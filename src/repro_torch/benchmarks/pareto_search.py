"""Paper Fig. 5 + Table 2: the greedy per-layer precision search.

Per network: initialize at the <0.1%-error uniform config (from the uniform
sweep), run the paper's slowest-gradient-descent, report the minimum-traffic
config within each error tolerance (1/2/5/10%) and its TR vs the 32-bit
baseline. Also runs the beyond-paper sensitivity-ordered search and reports
the evaluation-count saving.

    python -m repro_torch.benchmarks.pareto_search [--device D]

Results: ``results/torch_pareto_search.json``, the reference's keys; the
start policy comes from ``results/torch_uniform_sweep.json`` when present.
"""
from __future__ import annotations

import argparse

from ..core.fixedpoint import FixedPointFormat
from ..core.policy import PrecisionPolicy
from ..core.search import greedy_pareto_search, sensitivity_search
from ..models.cnn import cnn_traffic_model
from .common import cnn_nets, get_cnn, load_json, make_eval_fn, save_json

TOLERANCES = (0.01, 0.02, 0.05, 0.10)

# paper Table 2 TR values at 1% tolerance (32-bit baseline) for reference,
# by the names of the nets here (the paper's AlexNet is alexnet_small's)
PAPER_TR_1PCT = {"lenet": 0.08, "convnet": 0.24, "alexnet_small": 0.28}


def _init_policy(net, names, uniform):
    """Paper step 1: uniform start below 0.1% error, from the Fig 2 data."""
    u = uniform.get(net, {})
    base = u.get("baseline_accuracy", 1.0)

    def pick(d, default):
        t = base * 0.999
        ok = [int(k) for k, v in sorted(d.items(), key=lambda kv: int(kv[0]))
              if v >= t]
        return ok[0] if ok else default

    wf = pick(u.get("weight_frac", {}), 10) + 1  # +1 margin like the paper
    di = pick(u.get("data_int", {}), 10) + 1
    df = pick(u.get("data_frac", {}), 4)
    return PrecisionPolicy.uniform(
        names, FixedPointFormat(1, min(wf, 12)),
        FixedPointFormat(min(di, 12), min(df, 8)))


def searches(spec, eval_fn, base, init, *, batch=50):
    """(greedy result, sensitivity result at 10% tolerance) from ``init``."""
    tm = cnn_traffic_model(spec)
    # the paper fixes F for the deeper nets to shrink the space
    fields = ("weight_frac", "data_int") if len(spec.layers) > 5 else \
        ("weight_frac", "data_int", "data_frac")
    res = greedy_pareto_search(eval_fn, tm, init,
                               baseline_accuracy=float(base),
                               fields=fields, batch_size=batch,
                               mode="batch", verbose=False)
    res2 = sensitivity_search(eval_fn, tm, init,
                              baseline_accuracy=float(base), fields=fields,
                              batch_size=batch, tolerance=0.10)
    return res, res2


def summarize(res, res2, base):
    """The reference's record of one network's two searches."""
    out = {"baseline_accuracy": float(base),
           "evaluations": res.evaluations,
           "wall_seconds": res.wall_seconds,
           "tolerances": {}}
    for t in TOLERANCES:
        p = res.select(t)
        if p is None:
            continue
        bits = [f"{(lp.weight.total_bits if lp.weight else 32)}."
                f"{(lp.data.total_bits if lp.data else 32)}"
                for lp in p.policy.layers]
        out["tolerances"][f"{t:.0%}"] = {
            "traffic_ratio": p.traffic_ratio,
            "accuracy": p.accuracy,
            "bits_per_layer(W.D)": bits,
        }
    p2 = res2.select(0.01)
    out["sensitivity_search"] = {
        "evaluations": res2.evaluations,
        "tr@1%": p2.traffic_ratio if p2 else None,
        "speedup_vs_paper_evals": res.evaluations / max(res2.evaluations, 1),
    }
    out["pareto"] = [{"tr": p.traffic_ratio, "acc": p.accuracy}
                     for p in res.pareto()]
    return out


def search_network(net: str, *, device="cuda", batch=50, verbose=True,
                   uniform=None):
    spec, params, (xv, yv), base = get_cnn(net, device=device,
                                           verbose=verbose)
    init = _init_policy(net, spec.layer_names, uniform or {})
    res, res2 = searches(spec, make_eval_fn(spec, params, xv, yv), base,
                         init, batch=batch)
    return summarize(res, res2, base)


def run(*, device="cuda", verbose=True, nets=None):
    try:
        uniform = load_json("uniform_sweep.json")
    except FileNotFoundError:
        uniform = {}
    results = {}
    for net in nets or cnn_nets():
        if verbose:
            print(f"[pareto_search] {net} (this is the paper's §2.5 loop)")
        results[net] = search_network(net, device=device, verbose=verbose,
                                      uniform=uniform)
        if verbose:
            for tol, r in results[net]["tolerances"].items():
                print(f"  tol={tol:4s} TR={r['traffic_ratio']:.3f} "
                      f"acc={r['accuracy']:.4f} "
                      f"bits={'-'.join(r['bits_per_layer(W.D)'])}")
            ss = results[net]["sensitivity_search"]
            print(f"  sensitivity-search: {ss['evaluations']} evals "
                  f"({ss['speedup_vs_paper_evals']:.1f}x fewer), "
                  f"TR@1%={ss['tr@1%'] if ss['tr@1%'] is None else round(ss['tr@1%'], 3)}")
    save_json("pareto_search.json", results)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
