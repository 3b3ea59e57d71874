"""Paper Fig. 4 byte-traffic accounting: single-image vs batch use cases,
weights vs intermediate data, per network, extended with the transformer
analogue (prefill weight-dominated, decode KV-data-dominated per LM arch).
Host arithmetic, equal to the reference's ``benchmarks/traffic.py``
accounting. ``overload_trace_config`` and ``to_requests`` are the
reference harness's trace and its conversion to serve requests, and
``replay_overload`` serves that trace once under the harness's tiered
settings; the harness's gated runs (``run_serve``, ``run_replicas``) are
still to port (ROADMAP queue A item 10).

    python -m repro_torch.benchmarks.traffic              # accounting
    python -m repro_torch.benchmarks.traffic --mode replay --fast \
        --device cpu          # the overload trace, host tier + SLO sched

Results: ``results/torch_traffic.json`` (accounting).
"""
from __future__ import annotations

import argparse

import numpy as np

from .. import resolve_device
from ..configs.registry import ARCH_IDS, get_config, get_smoke_config
from ..core.traffic import TenantSpec, TraceConfig, generate_trace
from ..launch.serve import BatchedServer, Request
from ..models.transformer import init_model
from ..models.cnn import SPECS, cnn_traffic_model
from ..quant.apply import transformer_traffic_model
from .common import cnn_nets, save_json


def cnn_traffic(batch=50):
    out = {}
    for net in cnn_nets():
        tm = cnn_traffic_model(SPECS[net])
        w_s, d_s = tm.accesses(batch, "single")
        w_b, d_b = tm.accesses(batch, "batch")
        out[net] = {
            "single": {"weights_M": w_s / 1e6, "data_M": d_s / 1e6},
            "batch": {"weights_M": w_b / 1e6, "data_M": d_b / 1e6},
            "weights_dominate_single": bool(w_s > d_s),
            "data_dominate_batch": bool(d_b > w_b),
        }
    return out


def lm_traffic():
    """Prefill vs decode access counts for the LM archs (per device-step,
    analytic)."""
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        tm_p = transformer_traffic_model(cfg, batch=32, seq_len=32768,
                                         mode="prefill")
        w_p, d_p = tm_p.accesses(1, "batch")
        if cfg.family != "encoder":
            tm_d = transformer_traffic_model(cfg, batch=128, seq_len=32768,
                                             mode="decode")
            w_d, d_d = tm_d.accesses(1, "batch")
        else:
            w_d = d_d = 0
        out[arch] = {
            "prefill": {"weights_G": w_p / 1e9, "data_G": d_p / 1e9},
            "decode_per_token": {"weights_G": w_d / 1e9, "data_G": d_d / 1e9},
            "kv_data_dominates_decode": bool(d_d > w_d) if w_d else None,
        }
    return out


def run_accounting(*, verbose=True):
    res = {"cnn": cnn_traffic(), "lm": lm_traffic()}
    if verbose:
        print("[traffic] CNN (accesses in millions, batch=50):")
        for net, r in res["cnn"].items():
            print(f"  {net:14s} single: W={r['single']['weights_M']:8.1f} "
                  f"D={r['single']['data_M']:8.1f} | batch: "
                  f"W={r['batch']['weights_M']:8.1f} "
                  f"D={r['batch']['data_M']:8.1f}")
        print("[traffic] LM (accesses in billions):")
        for arch, r in res["lm"].items():
            d = r["decode_per_token"]
            print(f"  {arch:26s} prefill W={r['prefill']['weights_G']:8.2f} "
                  f"D={r['prefill']['data_G']:8.2f} | decode/tok "
                  f"W={d['weights_G']:7.2f} D={d['data_G']:7.2f}")
    save_json("traffic.json", res)
    return res


# ---------------------------------------------------------------------------
# the serving harness's trace
# ---------------------------------------------------------------------------
def overload_trace_config(vocab_size: int, *, fast=False) -> TraceConfig:
    """The saturated bursty mix: a deadlined interactive tenant (short
    decodes, shared Zipf-weighted system prompts) and a no-deadline batch
    tenant (long decodes that hold slots across bursts)."""
    return TraceConfig(
        seed=7, horizon=40 if fast else 72,
        rate=0.06, process="bursty", burst_rate=2.2,
        p_enter_burst=0.10, p_exit_burst=0.30,
        vocab_size=vocab_size,
        tenants=(
            TenantSpec("interactive", weight=0.72, priority=5,
                       deadline_slack=4,
                       prompt_mean=9.0, prompt_sigma=0.5, prompt_cap=15,
                       max_new_mean=3.0, max_new_sigma=0.4, max_new_cap=5,
                       shared_prefix_len=8, prefix_pool=2),
            TenantSpec("batch", weight=0.28, priority=0,
                       deadline_slack=None,
                       prompt_mean=12.0, prompt_sigma=0.5, prompt_cap=23,
                       max_new_mean=14.0, max_new_sigma=0.3,
                       max_new_cap=20),
        ))


def to_requests(trace):
    """Fresh serve requests for one replay (a Request is mutable run
    state, so two runs never share instances)."""
    return [Request(r.rid, np.array(r.prompt), r.max_new,
                    priority=r.priority, deadline_step=r.deadline_step,
                    arrive_step=r.arrive_step)
            for r in trace.requests]


def replay_overload(*, arch="qwen2-72b", fast=False, device="cuda",
                    verbose=True):
    """Serve the overload trace once on the smoke config with the serving
    harness's settings: a 13-page int8 pool well below the working set,
    the prefix cache, the host tier with the async pager and SLO
    scheduling without preemption. Returns the server and its requests."""
    cfg = get_smoke_config(arch)
    dev = resolve_device(device)
    trace = generate_trace(overload_trace_config(cfg.vocab_size, fast=fast))
    srv = BatchedServer(cfg, init_model(cfg, seed=0, device=dev),
                        batch_size=3, max_len=64, page_size=8,
                        num_pages=1 + 13, kv_bits=8, prefix_cache="on",
                        kv_offload="host", sched="slo", preempt=False,
                        metrics="on", pager_async="on", device=dev)
    reqs = srv.run(to_requests(trace), verbose=verbose)
    if verbose:
        slo = srv.tracer.slo_summary()
        print(f"[traffic] {len(trace.requests)} requests, overload "
              f"{trace.overload_ratio(3):.2f}x, goodput {slo['goodput']}, "
              f"{slo['deadline_misses']} deadline misses, pager "
              f"{srv.pager.demotions} demotions / {srv.pager.promotions} "
              f"promotions / {srv.pager.prefetch_hits} of "
              f"{srv.pager.prefetches} prefetches used")
    return srv, reqs


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["accounting", "replay"],
                    default="accounting")
    ap.add_argument("--fast", action="store_true",
                    help="replay: the short trace")
    ap.add_argument("--device", default="cuda",
                    help="replay: cuda (default) or cpu")
    args = ap.parse_args()
    if args.mode == "replay":
        replay_overload(fast=args.fast, device=args.device)
    else:
        run_accounting()
