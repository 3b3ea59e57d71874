"""Paper Fig. 3: per-layer precision tolerance — vary ONE layer at a time,
all other layers at full precision. The paper's key observation: the minimum
bits per layer varies WITHIN a network (>= a few bits of spread).

    python -m repro_torch.benchmarks.perlayer_sweep [--device D]

Results: ``results/torch_perlayer_sweep.json``, the reference's keys.
"""
from __future__ import annotations

import argparse

from ..core.fixedpoint import FixedPointFormat
from ..core.policy import LayerPolicy, PrecisionPolicy
from .common import cnn_nets, get_cnn, make_eval_fn, save_json
from .uniform_sweep import min_bits


def sweep_network(net: str, *, device="cuda", verbose=True):
    spec, params, (xv, yv), base = get_cnn(net, device=device,
                                           verbose=verbose)
    eval_fn = make_eval_fn(spec, params, xv, yv)
    names = spec.layer_names
    fp = PrecisionPolicy.fp32_baseline(names)
    out = {"baseline_accuracy": float(base), "per_layer": {}}

    for li, name in enumerate(names):
        rec = {"weight_frac": {}, "data_int": {}}
        for f in range(0, 9):
            pol = fp.replace_layer(li, LayerPolicy(FixedPointFormat(1, f),
                                                   None))
            rec["weight_frac"][f] = float(eval_fn(pol))
        for i in range(1, 10):
            pol = fp.replace_layer(li, LayerPolicy(None,
                                                   FixedPointFormat(i, 8)))
            rec["data_int"][i] = float(eval_fn(pol))
        rec["min_weight_frac@1%"] = min_bits(rec["weight_frac"], base * 0.99)
        rec["min_data_int@1%"] = min_bits(rec["data_int"], base * 0.99)
        out["per_layer"][name] = rec
        if verbose:
            print(f"  {net}/{name}: min W.F={rec['min_weight_frac@1%']} "
                  f"min D.I={rec['min_data_int@1%']}")

    wf = [r["min_weight_frac@1%"] for r in out["per_layer"].values()
          if r["min_weight_frac@1%"] is not None]
    out["weight_bits_spread"] = (max(wf) - min(wf)) if wf else None
    return out


def run(*, device="cuda", verbose=True, nets=None):
    results = {}
    for net in nets or cnn_nets():
        if verbose:
            print(f"[perlayer_sweep] {net}")
        results[net] = sweep_network(net, device=device, verbose=verbose)
        if verbose:
            print(f"  spread across layers (weight frac bits): "
                  f"{results[net]['weight_bits_spread']}")
    save_json("perlayer_sweep.json", results)
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
