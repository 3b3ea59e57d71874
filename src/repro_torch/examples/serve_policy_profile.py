"""Paper search -> per-layer KV profile -> serving, end to end.

The paper's §2.5 greedy search emits a per-layer PrecisionPolicy; here the
search output drives the serving memory footprint:

1. run ``core.search.greedy_pareto_search`` on a smoke LM, scoring each
   candidate policy by greedy-decode token agreement against the
   unquantized rollout (the serving-relevant accuracy proxy), with
   KV-dominated decode traffic as the cost model;
2. pick the cheapest policy within tolerance and write it to JSON
   (``PrecisionPolicy.to_json``: the file ``--kv-profile`` loads);
3. serve with the profile: each layer's paged pool is built in the
   container its searched data format needs (int4 pages for <= 4 bits,
   int8 for <= 8, float pages for float layers), with the shared-prefix
   page cache on, and compare at-rest KV bytes and tokens against uniform
   int8.

    python -m repro_torch.examples.serve_policy_profile [--device cpu]

Runs on the CUDA card by default and raises without one. The policy goes
to ``results/torch_kv_policy_qwen2_72b_smoke.json``.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.benchmarks import common
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.fixedpoint import FixedPointFormat
from repro_torch.core.policy import PrecisionPolicy
from repro_torch.core.search import greedy_pareto_search
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models.transformer import decode_step, init_model, prefill
from repro_torch.quant.apply import (build_model_quant,
                                     transformer_layer_names,
                                     transformer_traffic_model)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_smoke_config("qwen2-72b")
    model = init_model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)).to(dev)

    # -- 1. search: score = decode token agreement vs the float rollout ----
    steps = 6

    @torch.no_grad()
    def rollout(quant):
        logits, caches, pos = prefill(model, toks, cfg, quant=quant,
                                      max_len=toks.shape[1] + steps + 1)
        cur = logits.argmax(-1).to(torch.int32)
        out = [cur]
        for s in range(steps - 1):
            logits, caches = decode_step(model, cur, pos + s, caches, cfg,
                                         quant=quant)
            cur = logits.argmax(-1).to(torch.int32)
            out.append(cur)
        return torch.stack(out)

    ref = rollout(None)

    def eval_fn(policy):
        mq = build_model_quant(policy, cfg, quantize_kv=True,
                               quantize_activations=False)
        return float((rollout(mq) == ref).float().mean())

    names = transformer_layer_names(cfg)
    init = PrecisionPolicy.uniform(names, None, FixedPointFormat(2, 6))
    traffic = transformer_traffic_model(cfg, batch=1, seq_len=64,
                                        mode="decode")
    res = greedy_pareto_search(eval_fn, traffic, init,
                               fields=("data_int", "data_frac"),
                               max_steps=8, verbose=True)
    point = res.select(tolerance=0.05) or res.trajectory[-1]
    policy = point.policy
    print(f"\nsearched policy (traffic ratio "
          f"{point.traffic_ratio:.3f} vs fp32):\n{policy.table()}")

    # -- 2. the JSON file --kv-profile consumes -----------------------------
    path = common.RESULTS / "torch_kv_policy_qwen2_72b_smoke.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(policy.to_json())
    print(f"policy written to {path}")
    loaded = PrecisionPolicy.from_json(path.read_text())

    # -- 3. serve it: per-layer containers + shared-prefix cache ------------
    sys_prompt = rng.integers(0, cfg.vocab_size, 18).astype(np.int32)

    def mk():
        r = np.random.default_rng(7)
        return [Request(i, np.concatenate(
                    [sys_prompt, r.integers(0, cfg.vocab_size, 4)
                     .astype(np.int32)]), 8) for i in range(6)]

    def kv_bytes(srv):
        return sum(t.numel() * t.element_size() for layer in srv.caches
                   if "k_pages" in layer for t in layer.values())

    base = dict(batch_size=3, max_len=64, page_size=8, prefix_cache="on",
                device=dev)
    print("\n=== uniform int8 + prefix cache ===")
    srv8 = BatchedServer(cfg, model, kv_bits=8, **base)
    out8 = srv8.run(mk(), verbose=True)
    print("=== searched per-layer profile (--kv-profile) + prefix cache ===")
    srvp = BatchedServer(cfg, model, kv_profile=loaded, **base)
    outp = srvp.run(mk(), verbose=True)
    print(f"profile key: {srvp.profile_key}")

    agree = np.mean([np.mean(np.asarray(a.out) == np.asarray(b.out))
                     for a, b in zip(out8, outp)])
    b8, bp = kv_bytes(srv8), kv_bytes(srvp)
    print(f"\nat-rest KV pools: uniform-int8 {b8 / 2**10:.1f} KiB -> "
          f"profile {bp / 2**10:.1f} KiB ({bp / b8:.2f}x)")
    print(f"token agreement profile vs uniform-int8: {agree:.1%}")
    print(f"prefix stats (profile server): {srvp.prefix_cache.stats()}")
    leak8, leakp = srv8.release_prefix_cache(), srvp.release_prefix_cache()
    print(f"refcount leaks after release: int8={leak8} profile={leakp}")
    return {"policy": loaded, "bytes_int8": b8, "bytes_profile": bp,
            "agreement": float(agree), "leaks": (leak8, leakp),
            "evaluations": res.evaluations}


if __name__ == "__main__":
    main()
