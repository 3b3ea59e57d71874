"""Benchmark orchestrator of the port: one module per paper table/figure,
the kernel bench and the serving benches.

  uniform_sweep    — paper Fig. 2 (accuracy vs uniform bits, per network)
  perlayer_sweep   — paper Fig. 3 (per-layer tolerance; the key observation)
  traffic          — paper Fig. 4 accounting (single vs batch; + LM analogue)
  traffic_serve    — the bursty overload trace through the SLO scheduler,
                     predictor off vs on (``traffic.run_serve``)
  pareto_search    — paper Fig. 5 / Table 2 (greedy search, TR@1/2/5/10%,
                     and the sensitivity search)
  lm_precision     — beyond-paper: the same search on a transformer LM
  kernel_bench     — the CUDA kernels against their plain versions
  paged_serve      — paged vs dense KV serving, the mixed workload
  prefix_serve     — the shared-prefix workload
  overcommit_serve — the overcommitted workload through the host tier

The serving stages serve the reference's qwen2-72b smoke config, randomly
initialized from seed 0. The reference's ``roofline`` stage waits for
ROADMAP queue A item 13.

    python -m repro_torch.benchmarks.run [--only a,b] [--fast] [--device D]

``--fast`` restricts the CNNs to lenet + convnet and the serving benches
to their CI shapes. Without ``--only``, a sweep or search whose result
file exists is printed, not recomputed. A stage that fails raises:
nothing here catches it (the reference prints the failure and goes on).
"""
from __future__ import annotations

import argparse
import functools
import json
import time

from .. import resolve_device
from ..configs.registry import get_smoke_config
from ..models.transformer import init_model
from . import (common, kernel_bench, lm_precision, paged_serve,
               pareto_search, perlayer_sweep, traffic, uniform_sweep)

# expensive searches reuse their saved results unless named in --only
_CACHED = {"uniform_sweep": "uniform_sweep.json",
           "perlayer_sweep": "perlayer_sweep.json",
           "pareto_search": "pareto_search.json",
           "lm_precision": "lm_precision.json"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="")
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = args.device
    nets = ["lenet", "convnet"] if args.fast else None
    fast = args.fast

    @functools.cache
    def lm():
        """The serving stages' smoke config and model, built once."""
        cfg = get_smoke_config("qwen2-72b")
        return cfg, init_model(cfg, seed=0, device=resolve_device(dev))

    def serve(workload):
        return lambda: paged_serve.run(*lm(), fast=fast, workload=workload)

    stages = {
        "uniform_sweep": lambda: uniform_sweep.run(device=dev, nets=nets),
        "perlayer_sweep": lambda: perlayer_sweep.run(device=dev, nets=nets),
        "traffic": traffic.run_accounting,
        "traffic_serve": lambda: traffic.run_serve(*lm(), fast=fast),
        "pareto_search": lambda: pareto_search.run(device=dev, nets=nets),
        "lm_precision": lambda: lm_precision.run(
            steps=120 if fast else 300, device=dev),
        "kernel_bench": lambda: kernel_bench.run(device=dev),
        "paged_serve": serve("mixed"),
        "prefix_serve": serve("prefix"),
        "overcommit_serve": serve("overcommit"),
    }
    only = [s for s in args.only.split(",") if s]
    unknown = set(only) - set(stages)
    if unknown:
        raise SystemExit(f"unknown stages: {sorted(unknown)}")
    t00 = time.time()
    for name, fn in stages.items():
        if only and name not in only:
            continue
        t0 = time.time()
        print(f"\n===== {name} =====")
        cached = _CACHED.get(name)
        if cached and not only and (common.RESULTS
                                    / f"torch_{cached}").exists():
            print(f"[cached] results/torch_{cached} "
                  f"(pass --only {name} to recompute). Summary:")
            print(json.dumps(common.load_json(cached), indent=1)[:2500])
        else:
            fn()
        print(f"===== {name} done in {time.time() - t0:.0f}s =====")
    print(f"\nall benchmarks done in {time.time() - t00:.0f}s")


if __name__ == "__main__":
    main()
