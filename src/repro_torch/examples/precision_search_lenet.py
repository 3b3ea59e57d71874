"""The paper's full experiment on LeNet: train, calibrate, search, report —
including the calibration-based initialization (core.calibrate) that replaces
the paper's empirical integer-bit sweeps.

    python -m repro_torch.examples.precision_search_lenet [--device cpu]

Runs on the CUDA card by default and raises without one.
"""
import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.core.calibrate import RangeStats, calibrated_policy
from repro_torch.core.search import greedy_pareto_search, sensitivity_search
from repro_torch.data.synthetic import digits_dataset
from repro_torch.models.cnn import (LENET, cnn_accuracy, cnn_forward,
                                    cnn_loss, cnn_traffic_model, fp32_exact,
                                    images_nchw, init_cnn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    spec = LENET
    params = init_cnn(torch.Generator(device=dev).manual_seed(0), spec,
                      device=dev)
    leaves = [v.requires_grad_(True) for d in params.values()
              for v in d.values()]
    xs, ys = digits_dataset(3072, seed=0)
    xv, yv = digits_dataset(768, seed=1)
    xs, ys = images_nchw(xs, dev), torch.from_numpy(ys).long().to(dev)
    xv, yv = images_nchw(xv, dev), torch.from_numpy(yv).long().to(dev)
    print("training ...")
    for i in range(250):
        lo = (i * 64) % 3008
        with fp32_exact():
            loss = cnn_loss(params, {"image": xs[lo:lo + 64],
                                     "label": ys[lo:lo + 64]}, spec)
            grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(0.05 * g)
    for p in leaves:
        p.requires_grad_(False)
    base = cnn_accuracy(params, xv, yv, spec)
    print(f"baseline top-1: {base:.4f}")

    # --- calibration: observed ranges -> integer bits ----------------------
    # weights: direct; data: per-layer outputs via truncated-prefix forwards
    stats_w, stats_d = RangeStats(), RangeStats()
    x = xv[:64]
    for i, l in enumerate(spec.layers):
        stats_w.update(l.name, params[l.name]["w"])
        sub = dataclasses.replace(spec, layers=spec.layers[:i + 1])
        out = cnn_forward({k: params[k] for k in sub.layer_names}, x, sub)
        stats_d.update(l.name, out)

    pol0 = calibrated_policy(
        spec.layer_names,
        {n: stats_w.max_abs[n] for n in spec.layer_names},
        {n: stats_d.max_abs[n] for n in spec.layer_names},
        frac_bits_weight=8, frac_bits_data=2)
    print("calibrated init policy:")
    print(pol0.table())

    tm = cnn_traffic_model(spec)

    def eval_fn(pol):
        return cnn_accuracy(params, xv, yv, spec, pol)

    print("\npaper greedy search (slowest gradient descent):")
    res = greedy_pareto_search(eval_fn, tm, pol0, baseline_accuracy=base,
                               batch_size=50)
    print(res.table())

    print("\nbeyond-paper sensitivity-ordered search:")
    res2 = sensitivity_search(eval_fn, tm, pol0, baseline_accuracy=base,
                              batch_size=50, tolerance=0.10)
    print(res2.table())
    print(f"\nevaluations: paper={res.evaluations} "
          f"sensitivity={res2.evaluations} "
          f"({res.evaluations / max(res2.evaluations, 1):.1f}x fewer)")


if __name__ == "__main__":
    main()
