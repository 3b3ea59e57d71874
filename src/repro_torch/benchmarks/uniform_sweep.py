"""Paper Fig. 2: accuracy vs UNIFORM representation length across networks.

Three sweeps per network (all layers forced to the same format):
  (a) weight fractional bits (I fixed at 1 — weights live in [-1, 1]),
  (b) data integer bits (F fixed generous),
  (c) data fractional bits (I fixed from calibration).

    python -m repro_torch.benchmarks.uniform_sweep [--device D]

Results: ``results/torch_uniform_sweep.json``, the reference's keys.
"""
from __future__ import annotations

import argparse

from ..core.fixedpoint import FixedPointFormat
from ..core.policy import PrecisionPolicy
from .common import cnn_nets, get_cnn, make_eval_fn, save_json


def min_bits(d, thresh):
    """Smallest bit count whose accuracy reaches ``thresh`` (None if none)."""
    ok = [int(k) for k, v in sorted(d.items(), key=lambda kv: int(kv[0]))
          if v >= thresh]
    return ok[0] if ok else None


def sweep_network(net: str, *, device="cuda", verbose=True):
    spec, params, (xv, yv), base = get_cnn(net, device=device,
                                           verbose=verbose)
    eval_fn = make_eval_fn(spec, params, xv, yv)
    names = spec.layer_names
    out = {"baseline_accuracy": float(base), "weight_frac": {},
           "data_int": {}, "data_frac": {}}

    for f in range(0, 11):
        pol = PrecisionPolicy.uniform(names, FixedPointFormat(1, f), None)
        out["weight_frac"][f] = float(eval_fn(pol))
    for i in range(1, 13):
        pol = PrecisionPolicy.uniform(names, None, FixedPointFormat(i, 8))
        out["data_int"][i] = float(eval_fn(pol))
    for f in range(0, 9):
        pol = PrecisionPolicy.uniform(names, None, FixedPointFormat(8, f))
        out["data_frac"][f] = float(eval_fn(pol))

    t = base * 0.99
    out["min_weight_frac@1%"] = min_bits(out["weight_frac"], t)
    out["min_data_int@1%"] = min_bits(out["data_int"], t)
    out["min_data_frac@1%"] = min_bits(out["data_frac"], t)
    return out


def run(*, device="cuda", verbose=True, nets=None):
    results = {}
    for net in nets or cnn_nets():
        if verbose:
            print(f"[uniform_sweep] {net}")
        results[net] = sweep_network(net, device=device, verbose=verbose)
        if verbose:
            r = results[net]
            print(f"  base={r['baseline_accuracy']:.4f} "
                  f"min W.F@1%={r['min_weight_frac@1%']} "
                  f"min D.I@1%={r['min_data_int@1%']} "
                  f"min D.F@1%={r['min_data_frac@1%']}")
    save_json("uniform_sweep.json", results)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
