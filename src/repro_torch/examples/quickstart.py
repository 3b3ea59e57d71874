"""Quickstart: the paper's method in ~60 lines.

1. Build a tiny LeNet on procedural digits,
2. quantize per layer with Q(I,F) formats,
3. run the paper's greedy search,
4. print the accuracy/traffic Pareto table (paper Table 2 format).

    python -m repro_torch.examples.quickstart [--device cpu]

Runs on the CUDA card by default and raises without one.
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.core.fixedpoint import FixedPointFormat, fake_quant
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.search import greedy_pareto_search
from repro_torch.data.synthetic import digits_dataset
from repro_torch.models.cnn import (LENET, cnn_accuracy, cnn_loss,
                                    cnn_traffic_model, fp32_exact,
                                    images_nchw, init_cnn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)

    # --- the core op: the paper's memory-boundary conversion -------------
    x = torch.tensor([0.7311, -1.2, 3.9, 0.01], device=dev)
    print("fake_quant Q(2,4):", fake_quant(x, 2, 4))   # grid of 1/16ths

    # --- train LeNet quickly on synthetic digits -------------------------
    spec = LENET
    params = init_cnn(torch.Generator(device=dev).manual_seed(0), spec,
                      device=dev)
    leaves = [v.requires_grad_(True) for d in params.values()
              for v in d.values()]
    xs, ys = digits_dataset(2048, seed=0)
    xv, yv = digits_dataset(512, seed=1)
    xs, ys = images_nchw(xs, dev), torch.from_numpy(ys).long().to(dev)
    xv, yv = images_nchw(xv, dev), torch.from_numpy(yv).long().to(dev)
    print("training LeNet on procedural digits ...")
    for i in range(200):
        lo = (i * 64) % 1984
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

    # --- the paper's §2.5 search ------------------------------------------
    tm = cnn_traffic_model(spec)
    init = PrecisionPolicy.uniform(spec.layer_names,
                                   FixedPointFormat(1, 10),  # weights Q1.10
                                   FixedPointFormat(10, 4))  # data Q10.4
    res = greedy_pareto_search(
        lambda pol: cnn_accuracy(params, xv, yv, spec, pol),
        tm, init, baseline_accuracy=base, batch_size=50, verbose=False)
    print(res.table())
    pick = res.select(0.01)
    if pick:
        print(f"\nchosen mixed config @1% tolerance "
              f"(TR={pick.traffic_ratio:.3f}):")
        print(pick.policy.table())
    return res


if __name__ == "__main__":
    main()
