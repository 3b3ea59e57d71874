"""Serving example: continuous-batching decode with a quantized, paged KV
cache, and every lever the server stacks on it.

The KV cache is the dominant decode traffic (paper §2.4's "data" at batch
scale). In order of appearance:

* per-layer data bits (int8 Q(2,6) / int4 Q(2,2)) shrink every stored
  token, and the paged layout allocates the cache by pages in use instead
  of batch x max_len slabs, freeing them per request;
* bucketed prefill admits prompts in power-of-two chunks written straight
  into the pool (O(prompt/bucket) forwards instead of O(prompt)
  whole-batch steps); ``prefill_batch`` stacks same-bucket prompts of one
  admission cycle into one ``[n, bucket]`` forward;
* ``attn_impl="kernel"`` routes prefill chunks (S > 1) and decode (S = 1)
  through the CUDA paged-attention kernel (its plain version on the CPU);
  ``"gather"`` reads the pool through the dense gather, the reference
  route. The kernel's per-page online softmax reorders the sums, so the
  two agree within float tolerance, not bitwise;
* the shared-prefix page cache (``prefix_cache="on"``): requests sharing a
  system prompt alias its full pages (refcounted), copy the page they
  diverge inside, and prefill only their suffix; ``release_prefix_cache()``
  returns the leak count (0 = clean);
* fused rounds (``fused="on"``): one ragged ``[rows, S]`` program per
  scheduler cycle, prefill chunks and decode tokens together
  (``program_launches == cycles``), with prefix-aware wave dedupe;
* the tiered page store: ``kv_offload="host"`` demotes cold cached pages
  to host memory in their containers and promotes them back on a hit;
  ``sched="slo"`` orders admission by (priority, deadline, arrival) and
  preempts a less urgent running request, which resumes from its parked
  pages without a re-prefill; ``snapshot_prefix_cache`` /
  ``restore_prefix_cache`` carry cached chains across a restart;
* online precision adaptation (``kv_adapt="on"``): pool pressure first
  narrows cold cached pages one container step (fp -> int8 -> int4) into a
  device tier, before any host round trip;
* telemetry (``metrics="on"``): the request-lifecycle tracer (Chrome trace
  JSON, ``slo_summary``: TTFT, TPOT, goodput) and the metrics registry,
  whose ``reset()`` / ``checkpoint()`` / ``since()`` are the warm-up
  boundary;
* traffic at scale: a seeded bursty trace (``core.traffic``), the SLO
  monitor's windowed gauges, the deadline-miss predictor
  (``predictor="on"``) and the async pager (``pager_async="on"``);
* the multi-replica frontend (``launch.frontend``): the same trace through
  1 and 2 replicas with prefix-affinity routing and the shared prefix
  store.

Admission preflights a request's worst-case page demand: one that can
never fit the pool is rejected with ``core.paged_kv.OutOfPagesError``
(FIFO mode re-raises it after the serviceable traffic drained), one that
must wait is deferred.

    python -m repro_torch.examples.serve_quantized_kv [--device cpu]

Runs on the CUDA card by default and raises without one.
"""
import argparse
import tempfile
from pathlib import Path

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.paged_kv import OutOfPagesError
from repro_torch.core.traffic import (TenantSpec, TraceConfig,
                                      generate_trace, trace_fingerprint)
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models.transformer import init_model


def cache_bytes(caches):
    return sum(t.numel() * t.element_size() for layer in caches
               for t in layer.values())


def agreement(a_reqs, b_reqs):
    return np.mean([np.mean(np.asarray(a.out) == np.asarray(b.out))
                    for a, b in zip(a_reqs, b_reqs)])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_smoke_config("qwen2-72b")
    model = init_model(cfg, seed=0, device=dev)
    out = {}

    def server(**kw):
        return BatchedServer(cfg, model, device=dev, **kw)

    def mk():
        rng = np.random.default_rng(0)
        return [Request(i, rng.integers(0, cfg.vocab_size, 10)
                        .astype(np.int32), 12) for i in range(8)]

    print(f"=== {cfg.dtype} dense KV cache ===")
    srv_fp = server(batch_size=4, max_len=96)
    reqs_fp = srv_fp.run(mk(), verbose=True)

    print("=== int8 Q(2,6) dense KV cache ===")
    srv_q8 = server(batch_size=4, max_len=96, kv_bits=8)
    reqs_q8 = srv_q8.run(mk(), verbose=True)

    print("=== int4 Q(2,2) paged KV cache (page_size=16, bucketed "
          "prefill) ===")
    srv_p4 = server(batch_size=4, max_len=96, kv_bits=4, page_size=16,
                    num_pages=1 + 4 * 2, prefill_bucket=16)
    reqs_p4 = srv_p4.run(mk(), verbose=True)
    print(f"  bucketed prefill: {srv_p4.prefill_forwards} chunk forwards for "
          f"{srv_p4.prefill_tokens} prompt tokens "
          f"(stepwise would take {srv_p4.prefill_tokens - 8} whole-batch "
          f"steps)")

    print("=== int8 paged + the paged-attention kernel (prefill and "
          "decode) ===")
    srv_k = server(batch_size=4, max_len=96, kv_bits=8, page_size=16,
                   attn_impl="kernel")
    reqs_k = srv_k.run(mk(), verbose=True)

    print("=== int8 paged + batched prefill (same-bucket prompts stacked "
          "into one [n, bucket] forward) ===")
    srv_bp = server(batch_size=4, max_len=96, kv_bits=8, page_size=16,
                    prefill_batch=4)
    srv_sp = server(batch_size=4, max_len=96, kv_bits=8, page_size=16,
                    prefill_batch=1)
    reqs_bp = srv_bp.run(mk(), verbose=True)
    reqs_sp = srv_sp.run(mk())
    print(f"  prefill forwards: {srv_sp.prefill_forwards} sequential -> "
          f"{srv_bp.prefill_forwards} batched "
          f"(token agreement {agreement(reqs_sp, reqs_bp):.1%})")

    fp_b, q8_b = cache_bytes(srv_fp.caches), cache_bytes(srv_q8.caches)
    p4_b = cache_bytes(srv_p4.caches)
    print(f"\ncache footprint: {cfg.dtype}={fp_b / 2**20:.2f} MiB  "
          f"int8={q8_b / 2**20:.2f} MiB ({q8_b / fp_b:.2f}x)  "
          f"paged-int4={p4_b / 2**20:.2f} MiB ({p4_b / fp_b:.2f}x; "
          f"pool sized to live pages, not max_len)")
    print(f"token agreement fp vs int8-KV:        "
          f"{agreement(reqs_fp, reqs_q8):.1%}")
    print(f"token agreement fp vs paged-int4-KV:  "
          f"{agreement(reqs_fp, reqs_p4):.1%}")
    print(f"token agreement fp vs kernel route:   "
          f"{agreement(reqs_fp, reqs_k):.1%}")
    print(f"pages free after run: {srv_p4.allocator.num_free}/"
          f"{srv_p4.allocator.num_pages - 1} (all requests released)")
    out["footprint"] = (fp_b, q8_b, p4_b)

    print("=== int8 paged + shared-prefix page cache ===")
    rng = np.random.default_rng(3)
    sys_prompt = rng.integers(0, cfg.vocab_size, 22).astype(np.int32)
    mk_shared = lambda: [
        Request(i, np.concatenate([sys_prompt,
                                   np.random.default_rng(i).integers(
                                       0, cfg.vocab_size, 4)
                                   .astype(np.int32)]), 10)
        for i in range(8)]
    srv_px = server(batch_size=4, max_len=96, kv_bits=8, page_size=16,
                    prefix_cache="on")
    srv_px.run(mk_shared(), verbose=True)
    st = srv_px.prefix_cache.stats()
    print(f"  {st['hits']}/{st['lookups']} prompts hit the cache "
          f"({st['hit_tokens']} tokens aliased, {st['cow_copies']} CoW "
          f"copies); {srv_px.prefill_forwards_saved} prefill forwards saved")
    out["prefix"] = st
    print(f"  release_prefix_cache() -> {srv_px.release_prefix_cache()} "
          f"leaked pages (0 = every refcount balanced)")

    print("=== fused ragged forward: one program per scheduler cycle ===")
    srv_sep = server(batch_size=4, max_len=96, kv_bits=8, page_size=16,
                     prefill_bucket=16, prefix_cache="on", prefill_batch=1)
    reqs_sep = srv_sep.run(mk_shared(), verbose=True)
    srv_fu = server(batch_size=4, max_len=96, kv_bits=8, page_size=16,
                    prefill_bucket=16, prefix_cache="on", fused="on")
    reqs_fu = srv_fu.run(mk_shared(), verbose=True)
    print(f"  programs: {srv_sep.program_launches} separate -> "
          f"{srv_fu.program_launches} fused over {srv_fu.cycles} cycles "
          f"(one per cycle: {srv_fu.program_launches == srv_fu.cycles}); "
          f"wave dedupe aliased {srv_fu.wave_dedup_pages} page(s); "
          f"token agreement {agreement(reqs_sep, reqs_fu):.1%}")
    out["fused"] = (srv_sep.program_launches, srv_fu.program_launches,
                    srv_fu.cycles)
    for s in (srv_sep, srv_fu):
        assert s.release_prefix_cache() == 0

    print("=== tiered page store: host offload + SLO preemption + "
          "restart ===")
    mk_tiered = lambda: [
        Request(0, np.concatenate([sys_prompt, np.arange(3, dtype=np.int32)]),
                16, priority=0),                       # long, low priority
        Request(1, np.concatenate([sys_prompt, np.arange(2, dtype=np.int32)]),
                6, priority=5, arrive_step=4, deadline_step=24),  # urgent
        Request(2, np.concatenate([sys_prompt, np.arange(4, dtype=np.int32)]),
                8, priority=1, arrive_step=10),
    ]
    tiered_kw = dict(batch_size=1, max_len=96, kv_bits=8, page_size=16,
                     num_pages=5,                      # 4 usable: too small
                     prefix_cache="on", kv_offload="host", sched="slo")
    srv_t = server(**tiered_kw)
    reqs_t = srv_t.run(mk_tiered(), verbose=True)
    print(f"  {srv_t.preempt_count} preemption(s), {srv_t.resume_count} "
          f"resume(s), {srv_t.realias_skipped} victim-page demotion(s) "
          f"skipped by re-aliasing still-resident prefix nodes; "
          f"every request completed: "
          f"{all(r.done and r.error is None for r in reqs_t)}")
    print(f"  kv inventory (device/host split): {srv_t.kv_inventory()}")
    with tempfile.TemporaryDirectory() as tmp:
        snap = str(Path(tmp) / "prefix_pages.npz")
        n = srv_t.snapshot_prefix_cache(snap)
        srv_t2 = server(**tiered_kw)
        m = srv_t2.restore_prefix_cache(snap)
    srv_t2.run(mk_tiered())
    s2 = srv_t2.prefix_cache.stats()
    print(f"  restart: {n} pages snapshotted -> {m} restored to the host "
          f"tier; hit rate after restore {s2['hit_rate']:.0%} "
          f"({s2['promotions']} host pages promoted on demand)")
    out["tiered"] = (srv_t.preempt_count, srv_t.resume_count, n, m)
    for s in (srv_t, srv_t2):
        assert s.release_prefix_cache() == 0 and s.host_store.num_pages == 0

    print("=== online precision adaptation: requantize before demote ===")
    rng = np.random.default_rng(9)
    mk_adapt = lambda: [
        Request(i, np.concatenate([
            np.asarray(tenant, np.int32),
            rng.integers(0, cfg.vocab_size, 3).astype(np.int32)]), 8)
        for i, tenant in enumerate(
            rng.integers(0, cfg.vocab_size, (4, 18)))]
    srv_ad = server(batch_size=2, max_len=96, kv_bits=8, page_size=16,
                    num_pages=6,                       # 5 usable: too small
                    prefix_cache="on", kv_offload="host", kv_adapt="on")
    reqs_ad = srv_ad.run(mk_adapt(), verbose=True)
    st = srv_ad.prefix_cache.stats()
    print(f"  eviction chain requant->demote->drop: {st['requants']} "
          f"page(s) narrowed in place, {st['deepens']} deepened toward the "
          f"int4 floor, {st['demotions']} host demotion(s) "
          f"(requants before the first: {st['requants_at_first_demotion']}), "
          f"{st['tier_promotions']} parked page(s) promoted on a later hit")
    print(f"  kv inventory (device/host/tier): {srv_ad.kv_inventory()}")
    print(f"  every request completed: "
          f"{all(r.done and r.error is None for r in reqs_ad)}")
    out["adapt"] = st
    assert srv_ad.release_prefix_cache() == 0
    assert srv_ad.quant_tier.num_pages == 0
    assert srv_ad.host_store.num_pages == 0

    print("=== telemetry: lifecycle trace + SLO goodput (metrics on) ===")
    srv_tm = server(batch_size=1, max_len=96, kv_bits=8, page_size=16,
                    num_pages=5, prefix_cache="on", kv_offload="host",
                    sched="slo", metrics="on")
    srv_tm.run(mk_tiered(), verbose=True)
    slo = srv_tm.tracer.slo_summary()
    print(f"  slo_summary: goodput {slo['goodput']:.2f} "
          f"({slo['finished']}/{slo['requests']} finished, "
          f"{slo['deadline_misses']} deadline misses, "
          f"{slo['preemptions']} preemptions)")
    print(f"  ttft p50 {1e3 * slo['ttft_p50_s']:.1f} ms / p99 "
          f"{1e3 * slo['ttft_p99_s']:.1f} ms; "
          f"tpot p50 {1e3 * (slo['tpot_p50_s'] or 0):.2f} ms")
    m = srv_tm.metrics
    print(f"  registry: serve.decode_steps="
          f"{m.counter('serve.decode_steps').value} "
          f"serve.preempt_count={m.counter('serve.preempt_count').value} "
          f"prefix.hits={m.counter('prefix.hits').value} "
          f"kv.device_bytes={m.gauge('kv.device_bytes').value} "
          f"kv.host_pages={m.gauge('kv.host_pages').value}")
    # the warm-up boundary: deltas since a checkpoint, then a zeroing
    mark = m.checkpoint()
    srv_tm.run([Request(9, sys_prompt.copy(), 2)])
    delta = {k: v for k, v in m.since(mark).items() if v}
    print(f"  one more request after checkpoint(): since() = {delta}")
    m.reset()
    print(f"  after reset(): serve.decode_steps="
          f"{srv_tm.decode_steps}, kv.device_bytes (a gauge, kept)="
          f"{m.gauge('kv.device_bytes').value}")
    with tempfile.TemporaryDirectory() as tmp:
        trace_out = str(Path(tmp) / "serve_trace.json")
        srv_tm.tracer.export_chrome(trace_out)
        print(f"  {len(srv_tm.tracer.events)} trace events -> Chrome trace "
              f"JSON (load at https://ui.perfetto.dev or chrome://tracing)")
    out["telemetry"] = (slo, delta)
    assert srv_tm.release_prefix_cache() == 0

    print("=== traffic harness: seeded bursty trace -> SLO gauges + "
          "deadline-miss predictor ===")
    trace = generate_trace(TraceConfig(
        seed=5, horizon=24, rate=0.1, process="bursty", burst_rate=1.2,
        p_enter_burst=0.2, p_exit_burst=0.3, vocab_size=cfg.vocab_size,
        tenants=(
            TenantSpec("chat", weight=0.7, priority=5, deadline_slack=6,
                       prompt_mean=8, prompt_cap=14, max_new_mean=3,
                       max_new_cap=5, shared_prefix_len=8, prefix_pool=2),
            TenantSpec("batch", weight=0.3, max_new_mean=8, max_new_cap=12),
        )))
    print(f"  trace: {len(trace.requests)} arrivals over "
          f"{trace.config.horizon} steps, burst overload "
          f"{trace.overload_ratio(batch_size=2):.1f}x sustainable, "
          f"fingerprint {trace_fingerprint(trace)[:12]}... "
          f"(same seed = same stream, any process)")
    srv_tr = server(batch_size=2, max_len=96, kv_bits=8, page_size=16,
                    num_pages=9, prefix_cache="on", kv_offload="host",
                    sched="slo", preempt=False, metrics="on",
                    predictor="on", pager_async="on")
    srv_tr.run([Request(r.rid, np.array(r.prompt), r.max_new,
                        priority=r.priority, deadline_step=r.deadline_step,
                        arrive_step=r.arrive_step)
                for r in trace.requests], verbose=True)
    slo = srv_tr.tracer.slo_summary()
    gauges = {k: v for k, v in srv_tr.metrics.snapshot()["gauges"].items()
              if k.startswith("slo.")}
    print(f"  windowed slo.* gauges (live during the run, snapshot-streamed "
          f"via --metrics-out): goodput "
          f"{gauges['slo.window_goodput']:.2f} over "
          f"{gauges['slo.window_requests']:.0f} reqs, queue EWMA "
          f"{gauges['slo.queue_depth_ewma']:.1f}, arrival EWMA "
          f"{gauges['slo.arrival_rate_ewma']:.2f}/step")
    print(f"  predictor: {srv_tr.predictor.gated} speculative admission(s) "
          f"gated, {srv_tr.predictor.updates} online SGD update(s), final "
          f"hazard {srv_tr.predictor.hazard:.2f}; async pager "
          f"{srv_tr.pager.demotions} demotion(s) overlapped with decode")
    print(f"  exact post-hoc goodput {slo['goodput']:.2f} "
          f"({slo['deadline_misses']} deadline misses / {slo['requests']} "
          f"offered)")
    out["traffic"] = (len(trace.requests), slo)
    assert srv_tr.release_prefix_cache() == 0

    print("=== multi-replica frontend: prefix-affinity routing + shared "
          "prefix store ===")
    from repro_torch.launch.frontend import (ReplicaFrontend,
                                             aggregate_goodput,
                                             make_replicas,
                                             requests_from_trace)
    common = dict(batch_size=2, max_len=96, kv_bits=8, page_size=16,
                  num_pages=9, prefix_cache="on", kv_offload="host",
                  sched="slo", preempt=False, metrics="on",
                  pager_async="on", device=dev)
    goodput = {}
    for n in (1, 2):
        fe = ReplicaFrontend(make_replicas(n, cfg, model, **common))
        reqs, keys = requests_from_trace(trace)   # the same offered stream
        fe.run(reqs, keys)
        goodput[n] = aggregate_goodput(reqs)
        if n == 2:
            c = fe.metrics.snapshot()["counters"]
            out["replica_counters"] = c
            print(f"  2 replicas: routed "
                  f"[{c.get('frontend.routed_replica0', 0)}, "
                  f"{c.get('frontend.routed_replica1', 0)}], "
                  f"{c.get('frontend.affinity_hits', 0)} affinity hits, "
                  f"{c.get('frontend.rebalanced', 0)} rebalances, "
                  f"{c.get('frontend.shared_prefix_pages', 0)} prefix "
                  f"pages exchanged through the shared store")
    print(f"  aggregate goodput on the same trace: 1 replica "
          f"{goodput[1]:.2f} (== the plain server, bitwise) -> 2 replicas "
          f"{goodput[2]:.2f}")
    out["replica_goodput"] = goodput

    # admission preflight: a request whose prompt + max_new can never be
    # backed by the pool is rejected with counts, recorded on the request
    # and (FIFO mode) re-raised after the serviceable traffic drained
    tiny = server(batch_size=2, max_len=96, kv_bits=8, page_size=16,
                  num_pages=4)                         # 3 usable pages
    ok_req = Request(100, np.arange(8, dtype=np.int32), 8)
    try:
        tiny.run([Request(99, np.arange(40, dtype=np.int32), 50), ok_req])
    except OutOfPagesError as e:
        print(f"\nOutOfPagesError (expected): {e}")
        out["rejected"] = str(e)
    print(f"request behind the rejected head still served: {ok_req.done} "
          f"({len(ok_req.out)} tokens)")
    out["served_behind"] = (ok_req.done, len(ok_req.out))
    return out


if __name__ == "__main__":
    main()
