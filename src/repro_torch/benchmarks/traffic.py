"""Traffic benches: the paper's Fig. 4 byte-traffic accounting and the
traffic-at-scale serving harness, as the reference's
``benchmarks/traffic.py``.

**Accounting** (``run_accounting``, ``--mode accounting``): paper Fig. 4
access counts, single-image vs batch use cases, weights vs intermediate
data, per network, extended with the transformer analogue (prefill
weight-dominated, decode KV-data-dominated per LM arch). Host arithmetic,
equal to the reference's. Results: ``results/torch_traffic.json``.

**Serving harness** (``run_serve``, ``--mode serve``): replays the seeded
bursty overload trace (``overload_trace_config``: 2-state MMPP arrivals, a
deadlined interactive tenant over Zipf-weighted shared system prompts, a
no-deadline batch tenant) through the SLO scheduler with the async host
pager, predictor off and on, and raises, in the reference's words,
unless

  * the trace overloads: burst arrivals >= 1.5x the sustainable decode
    throughput (``Trace.overload_ratio``);
  * predictor-on goodput is strictly above predictor-off (the predictor's
    TPOT-slowdown feature reads the wall clock, so on a busy machine this
    gate follows the machine's load; ROADMAP queue C);
  * both arms agree >= 0.9 with an ample-pool reference server
    (``teacher_force=True``: each arm served once more fed the
    reference's tokens, that agreement gated, the free-running one
    reported);
  * the exported Chrome trace shows an async ``pager.*`` span on the
    pager track overlapping a ``decode_span``;
  * the predictor-on run streamed its JSONL snapshots.

Results: ``results/torch_traffic_serve.json``, the snapshot stream
``results/torch_metrics_traffic.jsonl``, the Chrome trace
``results/torch_trace_traffic.json`` and a point appended to
``results/torch_BENCH_serve.json``.

**Replica A/B** (``run_replicas``, ``--mode replicas``): the same trace
through a 1-replica ``launch.frontend.ReplicaFrontend`` and a 2-replica
pool (prefix-affinity routing, the cross-replica shared prefix store),
raising, in the reference's words, unless

  * the 1-replica frontend is the plain server: tokens, done flags and
    finish steps equal bit for bit;
  * both arms agree >= 0.9 with the ample-pool reference
    (``teacher_force=True``: gated on each arm served once more fed the
    reference's tokens, the free-running agreement reported);
  * 2-replica goodput is strictly above 1-replica goodput.

Results: ``results/torch_traffic_replicas.json`` and a trajectory point.

``--mode replay`` serves the trace once with the harness's settings
(``replay_overload``); ``--mode all`` runs the accounting, the serving
harness and the replica A/B, as the reference's.

    python -m repro_torch.benchmarks.traffic --mode serve --fast \
        --device cpu
    python -m repro_torch.benchmarks.traffic --mode replicas --fast \
        --device cpu
    python -m repro_torch.benchmarks.traffic --mode accounting

Serving runs on the CUDA card by default and raises without one.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..configs.registry import ARCH_IDS, get_config, get_smoke_config
from ..core.traffic import (TenantSpec, TraceConfig, generate_trace,
                            trace_fingerprint)
from ..launch.serve import BatchedServer, Request
from ..models.transformer import init_model
from ..models.cnn import SPECS, cnn_traffic_model
from ..quant.apply import transformer_traffic_model
from ..runtime.telemetry import PAGER_TID
from . import common
from .common import cnn_nets, save_json
from .lm_precision import teacher_force as _teacher_force


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


def _token_agreement(reqs, ref_by_rid) -> float:
    """Mean per-request agreement over each pair's common length (1 for
    two empty outputs, 0 when only one is empty)."""
    per_req = []
    for r in reqs:
        ref = ref_by_rid[r.rid].out
        if not ref and not r.out:
            per_req.append(1.0)
            continue
        n = min(len(r.out), len(ref))
        if n == 0:
            per_req.append(0.0)
            continue
        per_req.append(float(np.mean(
            np.asarray(r.out[:n]) == np.asarray(ref[:n]))))
    return float(np.mean(per_req))


def _pager_overlaps_decode(events) -> bool:
    """Does an async ``pager.*`` span on the pager track overlap a
    ``decode_span`` in time (half-open intervals of Chrome X events)?"""
    pager = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("tid") == PAGER_TID
             and str(e.get("name", "")).startswith("pager.")
             and (e.get("args") or {}).get("async")]
    decode = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("name") == "decode_span"]
    return any(p0 < d1 and d0 < p1
               for p0, p1 in pager for d0, d1 in decode)


def _slo_gauges(registry) -> dict:
    snap = registry.snapshot()["gauges"]
    return {k: v for k, v in sorted(snap.items())
            if k.startswith("slo.")}


def run_serve(cfg, model, *, arch="qwen2-72b", verbose=True, fast=False,
              teacher_force=False, vocab=None):
    """Replay the overload trace predictor off vs on and gate the control
    loop's win (see the module docstring). ``cfg`` and ``model`` come
    from the caller; ``vocab`` (default: the config's) bounds the trace's
    token ids."""
    vocab = vocab or cfg.vocab_size
    batch, page_size, max_len = 3, 8, 64
    # a pool well below the working set: cached prefixes demote to the
    # host tier under pressure (the async pager's traffic)
    num_pages = 1 + 13
    trace = generate_trace(overload_trace_config(vocab, fast=fast))
    overload = trace.overload_ratio(batch)
    if overload < 1.5:
        raise RuntimeError(
            f"traffic trace is not an overload: burst arrivals are only "
            f"{overload:.2f}x sustainable throughput (need >= 1.5) — "
            f"{len(trace.requests)} requests, burst rate "
            f"{trace.burst_rate_observed():.2f}/step")

    common_kw = dict(batch_size=batch, max_len=max_len, page_size=page_size,
                     num_pages=num_pages, kv_bits=8, prefix_cache="on",
                     kv_offload="host", sched="slo", preempt=False,
                     metrics="on", pager_async="on")
    results = common.RESULTS
    results.mkdir(parents=True, exist_ok=True)
    snap_path = results / "torch_metrics_traffic.jsonl"
    if snap_path.exists():
        snap_path.unlink()   # an append-mode stream: one bench, one stream

    def arm(predictor, forced=None, **extra):
        srv = BatchedServer(cfg, model, predictor=predictor,
                            device=model.device, **common_kw, **extra)
        if forced is not None:
            _teacher_force(srv, forced)
        t0 = time.perf_counter()
        reqs = srv.run(to_requests(trace))
        return srv, reqs, time.perf_counter() - t0

    srv_off, reqs_off, t_off = arm("off")
    srv_on, reqs_on, t_on = arm("on", snapshot_out=str(snap_path),
                                snapshot_every=5)
    slo_off = srv_off.tracer.slo_summary()
    slo_on = srv_on.tracer.slo_summary()

    # the agreement reference: an ample pool, every request fits on
    # arrival, so no admission policy stands in the way
    ref = BatchedServer(cfg, model, batch_size=batch, max_len=max_len,
                        page_size=page_size, kv_bits=8, device=model.device)
    ref_reqs = ref.run(to_requests(trace))
    ref_by_rid = {r.rid: r for r in ref_reqs}
    agree_off = _token_agreement(reqs_off, ref_by_rid)
    agree_on = _token_agreement(reqs_on, ref_by_rid)
    free = None
    if teacher_force:
        free = (agree_off, agree_on)
        forced = {r.rid: list(r.out) for r in ref_reqs}
        agree_off = _token_agreement(arm("off", forced)[1], ref_by_rid)
        agree_on = _token_agreement(arm("on", forced)[1], ref_by_rid)

    trace_path = srv_on.tracer.export_chrome(
        str(results / "torch_trace_traffic.json"))

    if min(agree_off, agree_on) < 0.9:
        raise RuntimeError(
            f"traffic replay broke decode numerics: token agreement "
            f"off={agree_off:.1%} on={agree_on:.1%} vs reference "
            f"(need >= 0.9 — admission policy must not touch math)")
    if slo_on["goodput"] is None or slo_off["goodput"] is None:
        raise RuntimeError("traffic replay produced no goodput — empty "
                           "trace or no finished requests")
    if slo_on["goodput"] <= slo_off["goodput"]:
        raise RuntimeError(
            f"deadline-miss predictor failed to buy goodput on the "
            f"overload trace: on={slo_on['goodput']:.3f} <= "
            f"off={slo_off['goodput']:.3f} "
            f"(misses {slo_on['deadline_misses']} vs "
            f"{slo_off['deadline_misses']})")
    if not _pager_overlaps_decode(srv_on.tracer.events):
        raise RuntimeError(
            "async pager produced no pager.* span overlapping a "
            "decode_span — D2H transfers are not hiding under decode")
    if not snap_path.exists():
        raise RuntimeError("predictor-on run emitted no JSONL metrics "
                           "snapshot stream")

    gauges = _slo_gauges(srv_on.metrics)
    res = {
        "arch": arch, "fast": fast, "batch": batch,
        "page_size": page_size, "num_pages": num_pages,
        "trace": {
            "requests": len(trace.requests),
            "horizon": trace.config.horizon,
            "offered_rate": trace.offered_rate,
            "burst_rate": trace.burst_rate_observed(),
            "burst_steps": len(trace.burst_steps),
            "overload_ratio": overload,
            "fingerprint": trace_fingerprint(trace),
        },
        "predictor_off": {
            "goodput": slo_off["goodput"],
            "deadline_misses": slo_off["deadline_misses"],
            "ttft_p50_s": slo_off["ttft_p50_s"],
            "ttft_p99_s": slo_off["ttft_p99_s"],
            "tpot_p50_s": slo_off["tpot_p50_s"],
            "tpot_p99_s": slo_off["tpot_p99_s"],
            "wall_s": t_off,
            "token_agreement": agree_off,
        },
        "predictor_on": {
            "goodput": slo_on["goodput"],
            "deadline_misses": slo_on["deadline_misses"],
            "ttft_p50_s": slo_on["ttft_p50_s"],
            "ttft_p99_s": slo_on["ttft_p99_s"],
            "tpot_p50_s": slo_on["tpot_p50_s"],
            "tpot_p99_s": slo_on["tpot_p99_s"],
            "wall_s": t_on,
            "token_agreement": agree_on,
            "predictor_updates":
                srv_on.metrics.counter("sched.predictor_updates").value,
            "predictor_gated":
                srv_on.metrics.counter("sched.predictor_gated").value,
            "pager_demotions":
                srv_on.metrics.counter("pager.demotions").value,
            "pager_promotions":
                srv_on.metrics.counter("pager.promotions").value,
        },
        "goodput_delta": slo_on["goodput"] - slo_off["goodput"],
        "slo_gauges_on": gauges,
        "trace_path": trace_path,
        "metrics_jsonl": str(snap_path),
    }
    if free is not None:
        res["predictor_off"]["token_agreement_free_running"] = free[0]
        res["predictor_on"]["token_agreement_free_running"] = free[1]
    if verbose:
        def note(i):
            return ("" if free is None else
                    f" (teacher-forced; free-running {free[i]:.1%})")
        print(f"[traffic] {len(trace.requests)} requests over "
              f"{trace.config.horizon} steps "
              f"({len(trace.burst_steps)} burst steps, "
              f"{overload:.1f}x overload at batch={batch})")
        print(f"  predictor off: goodput {slo_off['goodput']:.3f} "
              f"({slo_off['deadline_misses']} misses), "
              f"ttft p99 {1e3 * (slo_off['ttft_p99_s'] or 0):.1f} ms, "
              f"agreement {agree_off:.1%}{note(0)}")
        print(f"  predictor on:  goodput {slo_on['goodput']:.3f} "
              f"({slo_on['deadline_misses']} misses, "
              f"{res['predictor_on']['predictor_gated']} admissions "
              f"gated, {res['predictor_on']['predictor_updates']} SGD "
              f"updates), ttft p99 "
              f"{1e3 * (slo_on['ttft_p99_s'] or 0):.1f} ms, "
              f"agreement {agree_on:.1%}{note(1)}")
        print(f"  goodput delta +{res['goodput_delta']:.3f}; async pager "
              f"{res['predictor_on']['pager_demotions']} demotions / "
              f"{res['predictor_on']['pager_promotions']} promotions "
              f"overlapping decode -> {Path(trace_path).name}")
        print("  windowed gauges: "
              + ", ".join(f"{k.split('.', 1)[1]}={v:.3g}"
                          for k, v in gauges.items()))
    save_json("traffic_serve.json", res)
    point = {"when": time.strftime("%Y-%m-%d %H:%M:%S"), "arch": arch,
             "fast": fast, "summary": {"traffic": {
                 "goodput": slo_on["goodput"],
                 "goodput_off": slo_off["goodput"],
                 "goodput_delta": res["goodput_delta"],
                 "ttft_p99_s": slo_on["ttft_p99_s"],
                 "tpot_p50_s": slo_on["tpot_p50_s"],
                 "token_agreement": agree_on,
                 "overload_ratio": overload}}}
    path = common.append_trajectory(point)
    if verbose:
        print(f"  trajectory point appended to {path.name}")
    return res


def _frontend_counters(fe) -> dict:
    """The frontend's counters and every replica's namespaced host
    counters (``replica<i>.<name>``) of one arm, timers left out."""
    from ..launch.frontend import merged_snapshot
    return {k: v for k, v in merged_snapshot(fe)["counters"].items()
            if not k.endswith("_s")}


def run_replicas(cfg, model, *, arch="qwen2-72b", verbose=True, fast=False,
                 teacher_force=False, vocab=None, attn_impl="gather"):
    """1 against 2 replicas of ``model`` on the overload trace, gated as
    the module docstring says. ``cfg`` and ``model`` come from the caller
    (both replicas share the model); ``vocab`` (default: the config's)
    bounds the trace's token ids; ``attn_impl`` is every server's
    attention route. The result carries the reference's fields, and per
    arm its counters (``counters``: the frontend's and each replica's
    namespaced host counters) and generated tokens."""
    from ..launch.frontend import (ReplicaFrontend, aggregate_goodput,
                                   make_replicas, requests_from_trace)
    vocab = vocab or cfg.vocab_size
    batch, page_size, max_len = 3, 8, 64
    num_pages = 1 + 13
    trace = generate_trace(overload_trace_config(vocab, fast=fast))
    overload = trace.overload_ratio(batch)
    common_kw = dict(batch_size=batch, max_len=max_len, page_size=page_size,
                     num_pages=num_pages, kv_bits=8, prefix_cache="on",
                     kv_offload="host", sched="slo", preempt=False,
                     metrics="on", pager_async="on", attn_impl=attn_impl,
                     device=model.device)

    def arm(n, forced=None):
        servers = make_replicas(n, cfg, model, **common_kw)
        if forced is not None:
            for srv in servers:
                _teacher_force(srv, forced)
        fe = ReplicaFrontend(servers)
        reqs, keys = requests_from_trace(trace)
        t0 = time.perf_counter()
        fe.run(reqs, keys)
        return fe, reqs, time.perf_counter() - t0

    fe1, reqs1, t1 = arm(1)
    fe2, reqs2, t2 = arm(2)

    # identity: the 1-replica frontend IS the plain server
    plain = BatchedServer(cfg, model, **common_kw)
    plain_by_rid = {r.rid: r for r in plain.run(to_requests(trace))}
    for r in reqs1:
        p = plain_by_rid[r.rid]
        if (list(r.out) != list(p.out) or r.done != p.done
                or r.finish_step != p.finish_step):
            raise RuntimeError(
                f"1-replica frontend diverged from the plain server on "
                f"rid={r.rid}: out {r.out} vs {p.out}, done {r.done} vs "
                f"{p.done}, finish {r.finish_step} vs {p.finish_step}")

    # agreement with the ample-pool reference (no admission pressure)
    ref = BatchedServer(cfg, model, batch_size=batch, max_len=max_len,
                        page_size=page_size, kv_bits=8, attn_impl=attn_impl,
                        device=model.device)
    ref_reqs = ref.run(to_requests(trace))
    ref_by_rid = {r.rid: r for r in ref_reqs}
    agree1 = _token_agreement(reqs1, ref_by_rid)
    agree2 = _token_agreement(reqs2, ref_by_rid)
    free = None
    if teacher_force:
        free = (agree1, agree2)
        forced = {r.rid: list(r.out) for r in ref_reqs}
        agree1 = _token_agreement(arm(1, forced)[1], ref_by_rid)
        agree2 = _token_agreement(arm(2, forced)[1], ref_by_rid)
    if min(agree1, agree2) < 0.9:
        raise RuntimeError(
            f"replica routing broke decode numerics: token agreement "
            f"1rep={agree1:.1%} 2rep={agree2:.1%} vs reference "
            f"(need >= 0.9 — the frontend must not touch math)")

    g1 = aggregate_goodput(reqs1)
    g2 = aggregate_goodput(reqs2)
    if g1 is None or g2 is None:
        raise RuntimeError("replica replay produced no goodput")
    if g2 <= g1:
        raise RuntimeError(
            f"2-replica pool failed to buy goodput on the overload "
            f"trace: 2rep={g2:.3f} <= 1rep={g1:.3f} — scaling out must "
            f"convert the burst backlog into deadline hits")

    c1, c2 = _frontend_counters(fe1), _frontend_counters(fe2)
    res = {
        "arch": arch, "fast": fast, "batch": batch,
        "page_size": page_size, "num_pages": num_pages,
        "trace": {
            "requests": len(trace.requests),
            "horizon": trace.config.horizon,
            "overload_ratio": overload,
            "fingerprint": trace_fingerprint(trace),
        },
        "one_replica": {"goodput": g1, "token_agreement": agree1,
                        "wall_s": t1},
        "two_replica": {
            "goodput": g2, "token_agreement": agree2, "wall_s": t2,
            "routed": c2.get("frontend.routed", 0),
            "routed_per_replica": [
                c2.get(f"frontend.routed_replica{i}", 0) for i in (0, 1)],
            "affinity_hits": c2.get("frontend.affinity_hits", 0),
            "rebalanced": c2.get("frontend.rebalanced", 0),
            "shared_prefix_pages": c2.get("frontend.shared_prefix_pages", 0),
        },
        "goodput_delta": g2 - g1,
    }
    for key, c, reqs in (("one_replica", c1, reqs1),
                         ("two_replica", c2, reqs2)):
        res[key]["counters"] = c
        res[key]["gen_tokens"] = sum(len(r.out) for r in reqs)
    if free is not None:
        res["one_replica"]["token_agreement_free_running"] = free[0]
        res["two_replica"]["token_agreement_free_running"] = free[1]
    if verbose:
        two = res["two_replica"]

        def note(i):
            return ("" if free is None else
                    f" (teacher-forced; free-running {free[i]:.1%})")
        print(f"[traffic:replicas] {len(trace.requests)} requests, "
              f"{overload:.1f}x overload at batch={batch}")
        print(f"  1 replica:  aggregate goodput {g1:.3f}, "
              f"agreement {agree1:.1%}{note(0)} (identical to plain "
              f"server)")
        print(f"  2 replicas: aggregate goodput {g2:.3f}, "
              f"agreement {agree2:.1%}{note(1)}, routed "
              f"{two['routed_per_replica']}, "
              f"{two['affinity_hits']} affinity hits / "
              f"{two['rebalanced']} rebalances, "
              f"{two['shared_prefix_pages']} shared prefix pages")
        print(f"  goodput delta +{res['goodput_delta']:.3f}")
    save_json("traffic_replicas.json", res)
    point = {"when": time.strftime("%Y-%m-%d %H:%M:%S"), "arch": arch,
             "fast": fast, "summary": {"replicas": {
                 "goodput_1rep": g1,
                 "goodput_2rep": g2,
                 "goodput_delta": res["goodput_delta"],
                 "token_agreement_2rep": agree2,
                 "affinity_hits": res["two_replica"]["affinity_hits"],
                 "shared_prefix_pages":
                     res["two_replica"]["shared_prefix_pages"],
                 "overload_ratio": overload}}}
    path = common.append_trajectory(point)
    if verbose:
        print(f"  trajectory point appended to {path.name}")
    return res


def run(cfg=None, model=None, *, verbose=True, fast=False, mode="all"):
    """``accounting``, ``serve``, ``replicas`` (both need ``cfg`` and
    ``model``) or ``all`` (the three)."""
    if mode not in ("all", "serve", "accounting", "replicas"):
        raise ValueError(f"unknown mode {mode!r}")
    res = {}
    if mode in ("all", "accounting"):
        res["accounting"] = run_accounting(verbose=verbose)
    if mode in ("all", "serve"):
        res["serve"] = run_serve(cfg, model, verbose=verbose, fast=fast)
    if mode in ("all", "replicas"):
        res["replicas"] = run_replicas(cfg, model, verbose=verbose,
                                       fast=fast)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode",
                    choices=["all", "serve", "accounting", "replicas",
                             "replay"],
                    default="all")
    ap.add_argument("--fast", action="store_true",
                    help="the short trace")
    ap.add_argument("--device", default="cuda",
                    help="serve / replicas / replay: cuda (the default) "
                         "or cpu")
    args = ap.parse_args(argv)
    if args.mode == "replay":
        return replay_overload(fast=args.fast, device=args.device)
    cfg = model = None
    if args.mode in ("all", "serve", "replicas"):
        cfg = get_smoke_config("qwen2-72b")
        model = init_model(cfg, seed=0, device=resolve_device(args.device))
    return run(cfg, model, fast=args.fast, mode=args.mode)


if __name__ == "__main__":
    main()
