"""Shared substrate of the benches: train and cache the paper's three
CNNs, build accuracy eval_fns, result IO and the serving trajectory.

The paper evaluates pretrained zoo models; here each network is trained
once on its procedural dataset (``data.synthetic``) with the JAX package's
recipe (``benchmarks/common.py``) and cached, so every bench measures
accuracy against precision as the paper does (top-1, fixed eval set).

Results go under ``results/`` at the repository root with a ``torch_``
prefix (``results/torch_cnn/{net}.npz``, ``results/torch_*.json``), beside
and never over the reference's files. A cached network is an ``.npz`` in
the reference's own layout and keys (``{layer}_w`` HWIO, ``{layer}_b``),
so either package can read the other's. The serving benches append one
point a run to ``results/torch_BENCH_serve.json``
(:func:`append_trajectory`); the repository's ``BENCH_serve.json`` is the
reference's own record, which the port never reads or writes.
"""
from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..data.synthetic import digits_dataset, shapes32_dataset
from ..models.cnn import (SPECS, cnn_accuracy, cnn_loss, cnn_params_from_numpy,
                          cnn_params_to_numpy, fp32_exact, images_nchw,
                          init_cnn)

RESULTS = Path(__file__).resolve().parents[3] / "results"

_DATASETS = {
    "lenet": digits_dataset,
    "convnet": shapes32_dataset,
    "alexnet_small": shapes32_dataset,
}

_TRAIN_STEPS = {"lenet": 400, "convnet": 700, "alexnet_small": 900}
_LR = {"lenet": 0.05, "convnet": 0.03, "alexnet_small": 0.02}
BATCH = 64


def save_json(name: str, obj) -> Path:
    path = RESULTS / f"torch_{name}"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))
    return path


def load_json(name: str):
    return json.loads((RESULTS / f"torch_{name}").read_text())


@contextlib.contextmanager
def results_in(path):
    """Write every result under ``path`` for the duration of the block,
    then under the previous directory again."""
    global RESULTS
    saved, RESULTS = RESULTS, Path(path)
    try:
        yield RESULTS
    finally:
        RESULTS = saved


def trajectory_path() -> Path:
    """The port's serving trajectory: ``results/torch_BENCH_serve.json``."""
    return RESULTS / "torch_BENCH_serve.json"


def append_trajectory(point: dict) -> Path:
    """Append one serving bench point to :func:`trajectory_path` (a file
    that does not parse starts a fresh trajectory). Returns the path."""
    path = trajectory_path()
    traj = {"bench": "paged_serve", "trajectory": []}
    if path.exists():
        try:
            traj = json.loads(path.read_text())
        except (OSError, json.JSONDecodeError):
            pass
    traj.setdefault("trajectory", []).append(point)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(traj, indent=1))
    return path


def _params_path(net: str) -> Path:
    return RESULTS / "torch_cnn" / f"{net}.npz"


def sgd_momentum_step(params, mom, batch, spec, lr: float) -> torch.Tensor:
    """One step of the recipe, in place: ``m = 0.9 m + g; p -= lr m``.
    ``params`` leaves require grad, ``mom`` has their structure; returns the
    step's loss."""
    leaves = [v for d in params.values() for v in d.values()]
    with fp32_exact():
        loss = cnn_loss(params, batch, spec)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for p, m, g in zip(leaves, [v for d in mom.values()
                                    for v in d.values()], grads):
            m.mul_(0.9).add_(g)
            p.sub_(lr * m)
    return loss.detach()


def train_cnn(net: str, *, device="cuda",
              generator: Optional[torch.Generator] = None,
              params: Optional[Dict[str, dict]] = None,
              steps: Optional[int] = None,
              verbose=True) -> Tuple[Dict[str, dict], List[float]]:
    """SGD with momentum 0.9 (:func:`sgd_momentum_step`) on 4096 training
    images (seed 0) in batches of 64, from ``params`` or from
    :func:`init_cnn` drawn with ``generator`` (default: seed 0 on
    ``device``). Returns the parameters and each step's loss."""
    dev = resolve_device(device)
    spec = SPECS[net]
    steps = steps or _TRAIN_STEPS[net]
    xs, ys = _DATASETS[net](4096, seed=0)
    xs, ys = images_nchw(xs, dev), torch.from_numpy(ys).long().to(dev)
    if params is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = init_cnn(generator, spec, device=dev)
    params = {k: {kk: v.detach().clone().requires_grad_(True)
                  for kk, v in d.items()} for k, d in params.items()}
    mom = {k: {kk: torch.zeros_like(v) for kk, v in d.items()}
           for k, d in params.items()}
    losses = []
    t0 = time.time()
    n = (len(xs) // BATCH) * BATCH
    for i in range(steps):
        lo = (i * BATCH) % n
        losses.append(sgd_momentum_step(
            params, mom, {"image": xs[lo:lo + BATCH],
                          "label": ys[lo:lo + BATCH]}, spec, _LR[net]))
        if verbose and i % 100 == 0:
            print(f"  [{net}] step {i} loss {float(losses[-1]):.4f} "
                  f"({time.time() - t0:.0f}s)")
    params = {k: {kk: v.detach() for kk, v in d.items()}
              for k, d in params.items()}
    return params, torch.stack(losses).tolist()


def get_cnn(net: str, *, device="cuda", retrain=False, verbose=True):
    """Returns (spec, params, eval set (x, y), baseline accuracy), training
    and caching the network unless a cache exists (or ``retrain``). The
    eval set is fixed: 1024 images at seed 99, (N, C, H, W) and (N,) on
    ``device``."""
    dev = resolve_device(device)
    spec = SPECS[net]
    xv, yv = _DATASETS[net](1024, seed=99)
    xv, yv = images_nchw(xv, dev), torch.from_numpy(yv).long().to(dev)
    path = _params_path(net)
    if path.exists() and not retrain:
        with np.load(path) as npz:
            tree = {l.name: {"w": npz[f"{l.name}_w"], "b": npz[f"{l.name}_b"]}
                    for l in spec.layers}
        params = cnn_params_from_numpy(tree, spec, dev)
    else:
        params, _ = train_cnn(net, device=dev, verbose=verbose)
        path.parent.mkdir(parents=True, exist_ok=True)
        tree = cnn_params_to_numpy(params, spec)
        np.savez(path, **{f"{k}_{kk}": v for k, d in tree.items()
                          for kk, v in d.items()})
    base_acc = cnn_accuracy(params, xv, yv, spec)
    return spec, params, (xv, yv), base_acc


def make_eval_fn(spec, params, xv, yv):
    """policy -> top-1 accuracy (the search's eval_fn)."""
    def eval_fn(policy):
        return cnn_accuracy(params, xv, yv, spec, policy)
    return eval_fn


def cnn_nets():
    return ["lenet", "convnet", "alexnet_small"]
