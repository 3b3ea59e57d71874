"""Paged vs dense KV-cache serving bench: tokens/sec, prefill latency and
KV bytes per token-slot, over five workloads, as the reference's
``benchmarks/paged_serve.py``.

* **mixed** (:func:`run`): the same mixed-length request trace through
  five ``BatchedServer`` configurations: ``dense-fp32`` (one
  (B, max_len) slab per layer in the compute dtype), ``paged-int8-step``
  (int8 pages, stepwise prefill), ``paged-int8`` (bucketed prefill),
  ``paged-int4`` and ``paged-int8-kernel`` (bucketed prefill and decode
  through the CUDA paged-attention kernel; the reference's row is
  ``paged-int8-pallas``), then the shared-bucket batched-prefill stage
  (:func:`run_batched_prefill`).
* **prefix** (:func:`run_prefix`): requests sharing a system prompt,
  prefix cache off vs on, uniform int8 vs a per-layer profile vs page
  scales vs int4; raises on a refcount leak.
* **overcommit** (:func:`run_overcommit`): ~2.5x the pool's pages offered
  through the host tier, SLO scheduling and preemption, and a simulated
  restart from a prefix snapshot; raises on a rejected request, an
  unresumed victim or a leak.
* **adapt** (:func:`run_adapt`): a many-tenant trace with ``kv_adapt``
  off vs on (requantize before demote); raises unless requantization
  comes first, holds >= 2x the tokens before the first host round trip
  and passes the accuracy gate.
* **ragged** (:func:`run_ragged`): a saturated shared-prefix backlog,
  sequential vs batched admission (wave dedupe) vs ``fused="on"``; raises
  unless fused runs fewer programs at one a cycle and dedupe fewer
  prefill forwards.

Every gate raises the reference's ``RuntimeError`` words. The traces,
seeds, pool sizes and ``--fast`` shapes are the reference's. Each workload
function takes the config and the model from its caller (the CLI builds
the reference's smoke config, randomly initialized from seed 0), and
``vocab`` (default: the config's) bounds the token ids its traces draw,
so a full-width model can serve the very same requests as the smoke
config. ``teacher_force=True`` serves each compared run once more, fed
its reference run's tokens (``lm_precision.teacher_force``), gates that
agreement and reports the free-running one beside it; off, the gates are
the reference's free-running ones.

Results: ``results/torch_{paged,prefix,overcommit,adapt,ragged}_serve.json``
with the reference's keys, and one point a run appended to
``results/torch_BENCH_serve.json`` (``common.append_trajectory``; the
repository's ``BENCH_serve.json`` is the reference's record and is never
touched here).

    python -m repro_torch.benchmarks.paged_serve --fast --device cpu \\
        [--workload all|mixed|prefix|overcommit|adapt|ragged]

Runs on the CUDA card by default and raises without one. ``all`` runs
mixed, prefix and overcommit, as the reference; adapt and ragged run by
name.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..configs.registry import get_smoke_config
from ..core.fixedpoint import FixedPointFormat
from ..core.policy import LayerPolicy, PrecisionPolicy
from ..launch.serve import BatchedServer, Request
from ..models.transformer import init_model
from . import common
from .common import save_json
from .lm_precision import accuracy_gate, teacher_force

MAX_PROMPT = 13


def _export_trace(srv, name: str):
    """The server's Chrome trace to ``results/torch_<name>``, or None (and
    a note) when tracing is off."""
    if not srv.tracer.enabled:
        print(f"  [trace] skipped {name}: tracing disabled (metrics off)")
        return None
    path = common.RESULTS / f"torch_{name}"
    path.parent.mkdir(parents=True, exist_ok=True)
    return srv.tracer.export_chrome(str(path))


def _kv_cache_leaves(caches):
    """Yield (kind, tensor) for the attention caches' storage: a paged
    pool's pages and scales, a dense slab's k and v."""
    for layer in caches:
        if "k_pages" in layer:
            for k in ("k_pages", "v_pages", "k_scale", "v_scale"):
                yield k, layer[k]
        elif "k" in layer and "v" in layer:
            yield "k", layer["k"]
            yield "v", layer["v"]


def _kv_at_rest_bytes(srv) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in _kv_cache_leaves(srv.caches))


def cache_stats(srv):
    """(stored bytes, bytes backing tokens, token capacity) of the KV
    cache. A paged pool's scratch page backs no tokens: its share is left
    out of the per-token figure and kept in the total."""
    total = _kv_at_rest_bytes(srv)
    if srv.paged:
        P = srv.allocator.num_pages
        return total, total * (P - 1) / P, (P - 1) * srv.page_size
    return total, total, srv.B * srv.max_len


def mk_requests(vocab, n, max_new, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, MAX_PROMPT + 1, n)
    return [Request(i, rng.integers(0, vocab, L).astype(np.int32), max_new)
            for i, L in enumerate(lens)]


def _server(cfg, model, **kw) -> BatchedServer:
    return BatchedServer(cfg, model, device=model.device, **kw)


def _served(srv, reqs, forced=None):
    """Serve ``reqs`` on ``srv`` (teacher-forced by ``forced``, rid ->
    tokens, when given). Returns (srv, reqs, wall seconds)."""
    if forced is not None:
        teacher_force(srv, forced)
    t0 = time.perf_counter()
    srv.run(reqs)
    return srv, reqs, time.perf_counter() - t0


def _tokens(reqs) -> dict:
    return {r.rid: list(r.out) for r in reqs}


def _agreement(a_reqs, b_reqs) -> float:
    return float(np.mean([np.mean(np.asarray(a.out) == np.asarray(b.out))
                          for a, b in zip(a_reqs, b_reqs)]))


def _forced_note(free) -> str:
    return ("" if free is None
            else f" (teacher-forced; free-running {free:.1%})")


def bench_one(cfg, model, *, name, requests, batch, max_len, kv_bits,
              page_size, num_pages, attn_impl="gather", prefill="auto",
              prefill_bucket=16, prefill_batch=0, warmup=True, vocab=None):
    vocab = vocab or cfg.vocab_size
    srv = _server(cfg, model, batch_size=batch, max_len=max_len,
                  kv_bits=kv_bits, page_size=page_size, num_pages=num_pages,
                  attn_impl=attn_impl, prefill=prefill,
                  prefill_bucket=prefill_bucket, prefill_batch=prefill_batch)
    if warmup:
        # the decode step and every bucket the trace can hit (prompt lens
        # 3..MAX_PROMPT -> buckets 2..16) run once before the measured run
        rng = np.random.default_rng(99)
        srv.run([Request(1000 + i,
                         rng.integers(0, vocab, L).astype(np.int32), 2)
                 for i, L in enumerate([2, 3, 5, 9, min(13, max_len // 2)])])
        # one registry-wide zero at the warm-up boundary
        srv.metrics.reset()
    reqs = mk_requests(vocab, requests, max_new=srv.max_len // 2, seed=0)
    _, _, dt = _served(srv, reqs)
    gen = sum(len(r.out) for r in reqs)
    stored, usable, capacity = cache_stats(srv)
    return {
        "name": name,
        "kv_bits": kv_bits,
        "page_size": page_size,
        "attn_impl": srv.attn_impl,
        "prefill": srv.prefill_mode,
        "tokens_per_s": gen / max(dt, 1e-9),
        "prefill_forwards": srv.prefill_forwards,
        "prefill_latency_ms": 1e3 * srv.prefill_s / max(len(reqs), 1),
        "prefill_s": srv.prefill_s,
        "kv_bytes_per_token_slot": usable / capacity,
        "kv_cache_mib": stored / 2 ** 20,
        "token_capacity": capacity,
        "wall_s": dt,
    }


def run_batched_prefill(cfg, model, *, requests=8, batch=4, verbose=True,
                        fast=False, teacher_force=False, vocab=None):
    """Same-length prompts arriving together, sequential (prefill_batch 1)
    vs batched (the batch size) admission: batched must run strictly fewer
    prefill forwards and agree on the tokens (raises otherwise)."""
    vocab = vocab or cfg.vocab_size
    if fast:
        requests, batch = 4, 2
    plen, max_new, max_len, page_size = 11, 8, 64, 8
    per_slot = -(-(plen + max_new) // page_size)
    num_pages = 1 + batch * per_slot

    def mk():
        rng = np.random.default_rng(3)
        return [Request(i, rng.integers(0, vocab, plen).astype(np.int32),
                        max_new) for i in range(requests)]

    def serve(pb, forced=None):
        srv = _server(cfg, model, batch_size=batch, max_len=max_len,
                      page_size=page_size, num_pages=num_pages, kv_bits=8,
                      prefill="bucketed", prefill_bucket=16,
                      prefill_batch=pb)
        return _served(srv, mk(), forced)

    seq, reqs_seq, _ = serve(1)
    bat, reqs_bat, _ = serve(batch)
    agree, free = _agreement(reqs_seq, reqs_bat), None
    if teacher_force:
        free = agree
        agree = _agreement(reqs_seq,
                           serve(batch, _tokens(reqs_seq))[1])
    if agree < 0.9:
        raise RuntimeError(f"batched prefill broke decode: only {agree:.1%} "
                           f"token agreement with sequential admission")
    if bat.prefill_forwards >= seq.prefill_forwards:
        raise RuntimeError(
            f"batched prefill failed to reduce forwards on the shared-bucket "
            f"trace: {seq.prefill_forwards} sequential vs "
            f"{bat.prefill_forwards} batched")
    res = {
        "requests": requests, "batch": batch, "prompt_len": plen,
        "prefill_forwards_sequential": seq.prefill_forwards,
        "prefill_forwards_batched": bat.prefill_forwards,
        "prefill_forwards_reduction": (seq.prefill_forwards
                                       / max(bat.prefill_forwards, 1)),
        "ttft_ms_sequential": 1e3 * seq.prefill_s / requests,
        "ttft_ms_batched": 1e3 * bat.prefill_s / requests,
        "token_agreement": float(agree),
    }
    if free is not None:
        res["token_agreement_free_running"] = free
    if verbose:
        print(f"[batched_prefill] {requests} same-bucket prompts "
              f"(len {plen}, batch={batch}): "
              f"{res['prefill_forwards_sequential']} -> "
              f"{res['prefill_forwards_batched']} prefill forwards "
              f"({res['prefill_forwards_reduction']:.1f}x fewer), "
              f"TTFT {res['ttft_ms_sequential']:.1f} -> "
              f"{res['ttft_ms_batched']:.1f} ms/req, "
              f"agreement {agree:.1%}{_forced_note(free)}")
    return res


def _mixed_profile(cfg):
    """Per-layer KV policy with two bit-widths: even layers int8 Q(2,6),
    odd layers int4 Q(2,2), the shape of a search's output."""
    return PrecisionPolicy(
        tuple(f"layer_{i:03d}" for i in range(cfg.num_layers)),
        tuple(LayerPolicy(None, FixedPointFormat(2, 6 if i % 2 == 0 else 2))
              for i in range(cfg.num_layers)))


def mk_prefix_requests(vocab, n, sys_len, max_new, seed=0):
    """N requests sharing one system prompt plus a short random suffix."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, vocab, sys_len).astype(np.int32)
    return [Request(i, np.concatenate(
                [sys_prompt,
                 rng.integers(0, vocab, int(rng.integers(3, 8)))
                 .astype(np.int32)]), max_new)
            for i in range(n)]


def run_prefix(cfg, model, *, arch="qwen2-72b", requests=8, batch=4,
               verbose=True, fast=False, teacher_force=False, vocab=None):
    """Shared-prefix workload: prefix cache off vs on, uniform int8 vs a
    per-layer profile vs page scales vs int4. Raises on a token
    disagreement or a prefix-cache refcount leak."""
    vocab = vocab or cfg.vocab_size
    if fast:
        requests, batch = 4, 2
    # 42 = 5 full pages + 2 tokens into page 6: every hit aliases 5 pages
    # and copies the partly shared sixth
    sys_len, page_size, max_new, max_len = 42, 8, 8, 64
    # the pool is sized for the unshared worst case: on and off alike
    per_slot = -(-(sys_len + 7 + max_new) // page_size)
    num_pages = 1 + batch * per_slot + 2
    common_kw = dict(batch_size=batch, max_len=max_len, page_size=page_size,
                     num_pages=num_pages, prefill_bucket=16,
                     prefill_batch=1)

    def serve(forced=None, **kw):
        return _served(_server(cfg, model, **common_kw, **kw),
                       mk_prefix_requests(vocab, requests, sys_len, max_new,
                                          seed=0), forced)

    off, reqs_off, dt_off = serve(kv_bits=8, prefix_cache="off")
    on, reqs_on, dt_on = serve(kv_bits=8, prefix_cache="on")
    prof, _, _ = serve(kv_profile=_mixed_profile(cfg), prefix_cache="on")
    pscale, _, _ = serve(kv_bits=8, kv_scale="page", prefix_cache="on")
    int4, _, _ = serve(kv_bits=4, prefix_cache="on")

    agree, free = _agreement(reqs_off, reqs_on), None
    if teacher_force:
        free = agree
        forced, reqs_f, _ = serve(_tokens(reqs_off), kv_bits=8,
                                  prefix_cache="on")
        forced.release_prefix_cache()
        agree = _agreement(reqs_off, reqs_f)
    if agree < 0.9:
        raise RuntimeError(f"prefix sharing broke decode: only {agree:.1%} "
                           f"token agreement with sharing off")
    stats = on.prefix_cache.stats()
    for tag, srv in [("on", on), ("profile", prof), ("pscale", pscale),
                     ("int4", int4)]:
        leaked = srv.release_prefix_cache()
        if leaked or srv.allocator.num_free != srv.allocator.num_usable:
            raise RuntimeError(
                f"prefix-cache refcount leak in config {tag!r}: {leaked} "
                f"pages still cache-referenced, "
                f"{srv.allocator.num_usable - srv.allocator.num_free} "
                f"pages unreturned after all requests completed")
    bytes_int8 = _kv_at_rest_bytes(on)
    bytes_prof = _kv_at_rest_bytes(prof)
    bytes_int4 = _kv_at_rest_bytes(int4)
    res = {
        "arch": arch, "requests": requests, "batch": batch,
        "sys_prompt_len": sys_len, "page_size": page_size,
        "prefix_hit_rate": stats["hit_rate"],
        "prefix_token_hit_rate": stats["token_hit_rate"],
        "prefix_hit_tokens": stats["hit_tokens"],
        "cow_copies": stats["cow_copies"],
        "evictions": stats["evictions"],
        "prefill_forwards_off": off.prefill_forwards,
        "prefill_forwards_on": on.prefill_forwards,
        "prefill_forwards_saved": on.prefill_forwards_saved,
        "prefill_forwards_reduction": (
            off.prefill_forwards / max(on.prefill_forwards, 1)),
        "prefill_s_off": off.prefill_s,
        "prefill_s_on": on.prefill_s,
        "token_agreement_on_vs_off": float(agree),
        "kv_at_rest_bytes": {"uniform-int8": bytes_int8,
                             "profile-int8/int4": bytes_prof,
                             "uniform-int4": bytes_int4},
        "profile_bytes_vs_int8": bytes_prof / bytes_int8,
        "tokens_per_s_on": sum(len(r.out) for r in reqs_on) / max(dt_on,
                                                                  1e-9),
        "tokens_per_s_off": sum(len(r.out) for r in reqs_off) / max(dt_off,
                                                                    1e-9),
    }
    if free is not None:
        res["token_agreement_free_running"] = free
    if verbose:
        print(f"[prefix_serve] arch={arch} {requests} reqs sharing a "
              f"{sys_len}-token system prompt (batch={batch})")
        print(f"  hit rate {res['prefix_hit_rate']:.0%} requests / "
              f"{res['prefix_token_hit_rate']:.0%} prompt tokens; "
              f"{res['cow_copies']} CoW copies, {res['evictions']} evictions")
        print(f"  prefill forwards {res['prefill_forwards_off']} (off) -> "
              f"{res['prefill_forwards_on']} (on), "
              f"{res['prefill_forwards_reduction']:.1f}x fewer "
              f"({res['prefill_forwards_saved']} saved)")
        print(f"  at-rest KV: int8 {bytes_int8 / 2**10:.1f} KiB, "
              f"profile {bytes_prof / 2**10:.1f} KiB "
              f"({res['profile_bytes_vs_int8']:.2f}x), "
              f"int4 {bytes_int4 / 2**10:.1f} KiB")
        print(f"  token agreement on/off {agree:.1%}{_forced_note(free)}; "
              f"no refcount leaks")
    save_json("prefix_serve.json", res)
    return res


def mk_overcommit_requests(vocab, sys_len, *, waves, seed=0):
    """Three waves of decode-step arrivals over one system prompt: (1)
    low-priority long decodes that oversubscribe the pool, (2) later
    high-priority short deadlined requests that must preempt, (3) a tail
    hitting the shared prompt's demoted pages. ``waves = (n_long,
    n_urgent, n_tail)``."""
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, vocab, sys_len).astype(np.int32)
    n_long, n_urgent, n_tail = waves
    reqs, rid = [], 0

    def add(n, sfx_len, max_new, priority, arrive, deadline=None):
        nonlocal rid
        for _ in range(n):
            prompt = np.concatenate(
                [sys_prompt, rng.integers(0, vocab, sfx_len)
                 .astype(np.int32)])
            reqs.append(Request(rid, prompt, max_new, priority=priority,
                                arrive_step=arrive, deadline_step=deadline))
            rid += 1
    add(n_long, 3, 16, priority=0, arrive=0)
    add(n_urgent, 2, 6, priority=5, arrive=6, deadline=30)
    add(n_tail, 4, 8, priority=1, arrive=18)
    return reqs


def run_overcommit(cfg, model, *, arch="qwen2-72b", verbose=True,
                   fast=False, teacher_force=False, vocab=None):
    """Offered pages ~2.5x the device pool, through the host tier with SLO
    scheduling and preemption, then a simulated restart. Raises on a
    rejected waitable request, a victim never resumed, a token
    disagreement with an uninterrupted run, broken hit-rate parity after
    the restart, or a leak in the pool or the host tier."""
    vocab = vocab or cfg.vocab_size
    # fast keeps 4 long decodes: 3 no longer oversubscribe the pool
    waves = (4, 1, 2) if fast else (4, 2, 3)
    sys_len, page_size, max_len, batch = 21, 8, 64, 3
    num_pages = 1 + 11     # ~2 concurrent long requests
    mk = lambda: mk_overcommit_requests(vocab, sys_len, waves=waves,
                                        seed=0)
    common_kw = dict(batch_size=batch, max_len=max_len, page_size=page_size,
                     num_pages=num_pages, kv_bits=8, prefix_cache="on",
                     kv_offload="host", sched="slo", metrics="on")

    srv, reqs, dt = _served(_server(cfg, model, **common_kw), mk())
    offered_pages = sum(srv._pages_needed(r) for r in reqs)
    # SLO fields and the trace come from this cold run: the warm pass
    # below re-issues the same rids
    slo = srv.tracer.slo_summary()
    trace_path = _export_trace(srv, "trace_overcommit.json")
    n_events = len(srv.tracer.events)

    rejected = [r for r in reqs if r.error is not None]
    if rejected:
        raise RuntimeError(f"overcommit: {len(rejected)} waitable requests "
                           f"rejected with --kv-offload host (expected 0): "
                           f"{[r.rid for r in rejected]}")
    if not all(r.done and len(r.out) > 0 for r in reqs):
        raise RuntimeError("overcommit: not every request completed")
    if srv.preempt_count < 1:
        raise RuntimeError("overcommit trace failed to trigger preemption")
    if srv.resume_count != srv.preempt_count:
        raise RuntimeError(f"preempted {srv.preempt_count} but resumed "
                           f"{srv.resume_count} — a victim never came back")

    # preempted streams against an uninterrupted run
    _, reqs_ref, _ = _served(_server(cfg, model, batch_size=batch,
                                     max_len=max_len, page_size=page_size,
                                     kv_bits=8), mk())
    by_rid = {r.rid: r for r in reqs_ref}

    def agreement(test):
        return float(np.mean([np.mean(np.asarray(r.out)
                                      == np.asarray(by_rid[r.rid].out))
                              for r in test]))
    agree, free = agreement(reqs), None
    if teacher_force:
        free = agree
        forced, reqs_f, _ = _served(_server(cfg, model, **common_kw), mk(),
                                    _tokens(reqs_ref))
        forced.release_prefix_cache()
        agree = agreement(reqs_f)
    if agree < 0.9:
        raise RuntimeError(f"overcommit decode disagrees with the "
                           f"uninterrupted reference: {agree:.1%}")

    inv = srv.kv_inventory()
    stats = srv.prefix_cache.stats()

    # simulated restart: snapshot -> fresh server -> restore
    with tempfile.TemporaryDirectory(prefix="kv_snapshot_") as tmp:
        snap = str(Path(tmp) / "prefix_pages.npz")
        snap_pages = srv.snapshot_prefix_cache(snap)
        # the warm reference: a second pass on the original server
        l0, h0 = srv.prefix_cache.lookups, srv.prefix_cache.hits
        srv.run(mk())
        warm_rate = ((srv.prefix_cache.hits - h0)
                     / max(srv.prefix_cache.lookups - l0, 1))
        srv2 = _server(cfg, model, **common_kw)
        restored = srv2.restore_prefix_cache(snap)
    reqs2 = srv2.run(mk())
    s2 = srv2.prefix_cache.stats()
    if not all(r.done and r.error is None for r in reqs2):
        raise RuntimeError("restored server failed the overcommit trace")
    if s2["hit_rate"] < warm_rate - 0.05:
        raise RuntimeError(
            f"restart hit-rate parity broken: restored {s2['hit_rate']:.0%}"
            f" vs warm {warm_rate:.0%}")

    for tag, s in [("primary", srv), ("restored", srv2)]:
        leaked = s.release_prefix_cache()
        if leaked or s.allocator.num_free != s.allocator.num_usable:
            raise RuntimeError(
                f"allocator refcount leak ({tag}): {leaked} cache pages, "
                f"{s.allocator.num_usable - s.allocator.num_free} "
                f"unreturned")
        if s.host_store.num_pages != 0:
            raise RuntimeError(
                f"host-tier page leak ({tag}): {s.host_store.num_pages} "
                f"pages still parked after release")

    res = {
        "arch": arch, "requests": len(reqs), "batch": batch,
        "page_size": page_size, "device_pages": num_pages - 1,
        "offered_pages": offered_pages,
        "overcommit_ratio": offered_pages / (num_pages - 1),
        "completed": len(reqs), "rejected": 0,
        "preemptions": srv.preempt_count, "resumes": srv.resume_count,
        "realias_skipped_demotions": srv.realias_skipped,
        "ooo_admissions": srv.scheduler.ooo_admissions,
        "demotions": stats["demotions"], "promotions": stats["promotions"],
        "host_peak_pages": srv.host_store.peak_pages,
        "host_peak_bytes": srv.host_store.peak_bytes,
        "kv_inventory": inv,
        "prefix_hit_rate_cold": stats["hit_rate"],
        "prefix_hit_rate_warm": warm_rate,
        "prefix_hit_rate_restored": s2["hit_rate"],
        "snapshot_pages": snap_pages, "restored_pages": restored,
        "token_agreement_vs_uninterrupted": float(agree),
        "tokens_per_s": sum(len(r.out) for r in reqs) / max(dt, 1e-9),
        "wall_s": dt,
        "goodput": slo["goodput"],
        "deadline_misses": slo["deadline_misses"],
        "ttft_p50_s": slo["ttft_p50_s"], "ttft_p99_s": slo["ttft_p99_s"],
        "tpot_p50_s": slo["tpot_p50_s"], "tpot_p99_s": slo["tpot_p99_s"],
        "trace_path": trace_path, "trace_events": n_events,
    }
    if free is not None:
        res["token_agreement_free_running"] = free
    if verbose:
        print(f"[overcommit_serve] arch={arch} offered "
              f"{offered_pages} pages onto a {num_pages - 1}-page pool "
              f"({res['overcommit_ratio']:.1f}x overcommit, batch={batch})")
        print(f"  {len(reqs)} completed / 0 rejected; "
              f"{srv.preempt_count} preemptions (all resumed, "
              f"{res['realias_skipped_demotions']} victim-page demotions "
              f"skipped by re-aliasing), "
              f"{res['ooo_admissions']} out-of-order admissions")
        print(f"  tiers: device {inv['device_bytes'] / 2**10:.1f} KiB "
              f"{inv['device_by_container']} | host peak "
              f"{res['host_peak_pages']} pages "
              f"{res['host_peak_bytes'] / 2**10:.1f} KiB "
              f"({stats['demotions']} demotions, {stats['promotions']} "
              f"promotions)")
        print(f"  restart: {snap_pages} pages snapshotted, {restored} "
              f"restored; hit rate cold {res['prefix_hit_rate_cold']:.0%} "
              f"-> warm {warm_rate:.0%} -> restored {s2['hit_rate']:.0%}")
        print(f"  agreement vs uninterrupted run {agree:.1%}"
              f"{_forced_note(free)}; no leaks")
        print(f"  slo: goodput {res['goodput']:.2f} "
              f"({res['deadline_misses']} deadline misses), ttft p50 "
              f"{1e3 * (res['ttft_p50_s'] or 0):.1f} ms / p99 "
              f"{1e3 * (res['ttft_p99_s'] or 0):.1f} ms, tpot p50 "
              f"{1e3 * (res['tpot_p50_s'] or 0):.2f} ms; {n_events} trace "
              f"events -> {Path(trace_path).name if trace_path else None}")
    save_json("overcommit_serve.json", res)
    return res


def mk_adapt_requests(vocab, sys_len, *, groups, per_group, reuse_groups,
                      seed=0):
    """``groups`` tenants, each sharing its own system prompt over
    ``per_group`` requests, plus a late second wave re-issuing the first
    ``reuse_groups`` tenants' prompts verbatim (their pages are parked in
    the quant tier by then: the re-hits take the lossy promotion path)."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, vocab, sys_len).astype(np.int32)
                for _ in range(groups)]
    reqs, rid = [], 0
    wave2 = []
    for g in range(groups):
        for _ in range(per_group):
            prompt = np.concatenate(
                [prefixes[g], rng.integers(0, vocab, 5).astype(np.int32)])
            reqs.append(Request(rid, prompt, 4))
            rid += 1
            if g < reuse_groups:
                wave2.append(prompt)
    for prompt in wave2:
        reqs.append(Request(rid, prompt.copy(), 4, arrive_step=30))
        rid += 1
    return reqs


def run_adapt(cfg, model, *, arch="qwen2-72b", verbose=True, fast=False,
              teacher_force=False, vocab=None):
    """The many-tenant overcommitted trace through one small pool and host
    tier, ``kv_adapt`` off (byte-exact demote / drop) vs on (cold cached
    pages requantize one container step into the device tier first).
    Raises unless the off run demotes to the host, the on run requantizes
    before its first demotion and holds >= 2x the off run's tokens before
    the first host round trip, the on run passes the accuracy gate against
    the off run, and the pool and both tiers drain."""
    vocab = vocab or cfg.vocab_size
    groups, per_group, reuse = (5, 2, 2) if fast else (7, 2, 2)
    sys_len, page_size, max_len, batch = 8, 4, 64, 2
    num_pages = 1 + 9
    usable = num_pages - 1
    mk = lambda: mk_adapt_requests(vocab, sys_len, groups=groups,
                                   per_group=per_group, reuse_groups=reuse,
                                   seed=0)
    # a float pool: the ladder starts at fp -> int8; the tier's budget is
    # 4x the pool in int4-page units
    common_kw = dict(batch_size=batch, max_len=max_len, page_size=page_size,
                     num_pages=num_pages, prefix_cache="on",
                     kv_offload="host", prefill_batch=1)

    def serve(forced=None, **kw):
        return _served(_server(cfg, model, **common_kw, **kw), mk(), forced)

    off, reqs_off, dt_off = serve(kv_adapt="off")
    on, reqs_on, dt_on = serve(kv_adapt="on", adapt_pages=4 * usable)
    s_off = off.prefix_cache.stats()
    s_on = on.prefix_cache.stats()

    if s_off["demotions"] < 1:
        raise RuntimeError(
            f"adapt trace failed to pressure the pool: adapt-off run paid "
            f"{s_off['demotions']} host demotions (expected >= 1)")
    if s_on["requants"] < 1:
        raise RuntimeError("adapt run performed no requantizations")
    if s_on["demotions"] > 0 and not (s_on["requants_at_first_demotion"]
                                      or 0) >= 1:
        raise RuntimeError(
            f"adapt run demoted to host before its first requantization "
            f"(requants_at_first_demotion="
            f"{s_on['requants_at_first_demotion']})")
    tier_peak = on.quant_tier.peak_pages
    tokens_off = usable * page_size
    tokens_on = ((usable + tier_peak) * page_size
                 if s_on["demotions"] == 0 else tokens_off)
    token_ratio = tokens_on / tokens_off
    if token_ratio < 2.0:
        raise RuntimeError(
            f"adaptation held only {token_ratio:.2f}x the off run's tokens "
            f"before the first host round trip (expected >= 2x: pool "
            f"{usable} pages + tier peak {tier_peak}, "
            f"{s_on['demotions']} demotions)")
    # the off run round-trips bytes exactly, so it is the reference; a
    # bounded fraction of 4-token requests may flip on a tie
    gate_kw = dict(min_agreement=0.9, request_floor=0.5,
                   allowed_below_floor=0.15)
    gate = accuracy_gate([r.out for r in reqs_off],
                         [r.out for r in reqs_on], **gate_kw)
    free = None
    if teacher_force:
        free = gate["agreement"]
        forced, reqs_f, _ = serve(_tokens(reqs_off), kv_adapt="on",
                                  adapt_pages=4 * usable)
        forced.release_prefix_cache()
        gate = accuracy_gate([r.out for r in reqs_off],
                             [r.out for r in reqs_f], **gate_kw)
    if not gate["passed"]:
        raise RuntimeError(
            f"accuracy gate: {gate['violations']} violations "
            f"(overall agreement {gate['agreement']:.1%}, "
            f"per-request min {min(gate['per_request']):.1%})")

    inv = on.kv_inventory()
    for tag, s in [("off", off), ("on", on)]:
        leaked = s.release_prefix_cache()
        if leaked or s.allocator.num_free != s.allocator.num_usable:
            raise RuntimeError(
                f"refcount leak (adapt {tag}): {leaked} cache pages, "
                f"{s.allocator.num_usable - s.allocator.num_free} "
                f"unreturned")
        if s.host_store.num_pages != 0:
            raise RuntimeError(f"host-tier leak (adapt {tag}): "
                               f"{s.host_store.num_pages} pages parked")
    if on.quant_tier.num_pages != 0 or on.quant_tier.nbytes != 0:
        raise RuntimeError(
            f"quant-tier leak: {on.quant_tier.num_pages} pages / "
            f"{on.quant_tier.nbytes} bytes still parked after release")

    res = {
        "arch": arch, "requests": len(reqs_on), "batch": batch,
        "page_size": page_size, "device_pages": usable,
        "tenant_groups": groups,
        "requants": s_on["requants"], "deepens": s_on["deepens"],
        "tier_promotions": s_on["tier_promotions"],
        "tier_peak_pages": tier_peak,
        "tier_peak_bytes": on.quant_tier.peak_bytes,
        "requants_at_first_demotion": s_on["requants_at_first_demotion"],
        "demotions_off": s_off["demotions"],
        "demotions_on": s_on["demotions"],
        "evictions_off": s_off["evictions"],
        "evictions_on": s_on["evictions"],
        "tokens_before_host_off": tokens_off,
        "tokens_before_host_on": tokens_on,
        "token_ratio_vs_off": token_ratio,
        "accuracy_gate": {k: gate[k] for k in
                          ("agreement", "violations", "passed")},
        "kv_inventory": inv,
        "tokens_per_s_on": sum(len(r.out) for r in reqs_on) / max(dt_on,
                                                                  1e-9),
        "tokens_per_s_off": sum(len(r.out) for r in reqs_off) / max(dt_off,
                                                                    1e-9),
    }
    if free is not None:
        res["token_agreement_free_running"] = free
    if verbose:
        print(f"[adapt_serve] arch={arch} {groups} tenants x {per_group} "
              f"reqs + {reuse * per_group} re-hits onto a {usable}-page "
              f"pool (batch={batch})")
        print(f"  adapt off: {s_off['demotions']} host demotions, "
              f"{s_off['evictions']} destructive evictions")
        print(f"  adapt on: {s_on['requants']} requants "
              f"({s_on['deepens']} deepens, {s_on['tier_promotions']} lossy "
              f"promotions), {s_on['demotions']} host demotions; tier peak "
              f"{tier_peak} pages / {on.quant_tier.peak_bytes / 2**10:.1f} "
              f"KiB {inv['tier_by_container']}")
        print(f"  tokens before first host round trip: {tokens_off} -> "
              f"{tokens_on} ({token_ratio:.1f}x)")
        print(f"  accuracy gate: agreement {gate['agreement']:.1%}"
              f"{_forced_note(free)}, {gate['violations']} violations; "
              f"no leaks")
    save_json("adapt_serve.json", res)
    return res


def run_ragged(cfg, model, *, arch="qwen2-72b", requests=12, batch=4,
               verbose=True, fast=False, teacher_force=False, vocab=None):
    """A saturated shared-prefix backlog (every request queued at t=0)
    served three ways: ``seq`` (prefill_batch 1, separate programs),
    ``bat`` (batched admission with the prefix cache: wave dedupe) and
    ``fus`` (``fused="on"``: one ragged program a cycle). Raises unless
    fused runs strictly fewer programs than seq at exactly one a cycle,
    dedupe runs strictly fewer prefill forwards than seq, both agree
    >= 0.9 with seq, and every pool drains."""
    vocab = vocab or cfg.vocab_size
    if fast:
        requests = 8
    sys_len, max_new, max_len, page_size = 18, 12 if fast else 16, 64, 8
    per_slot = -(-(sys_len + 8 + max_new) // page_size)
    num_pages = 1 + batch * per_slot + 10   # headroom for retained prefixes

    def serve(name, forced=None, **kw):
        srv = _server(cfg, model, batch_size=batch, max_len=max_len,
                      page_size=page_size, num_pages=num_pages, kv_bits=8,
                      prefill="bucketed", prefill_bucket=16,
                      prefix_cache="on", metrics="on", **kw)
        srv, reqs, dt = _served(srv, mk_prefix_requests(
            vocab, requests, sys_len, max_new, seed=5), forced)
        assert all(r.done for r in reqs), f"{name}: unfinished requests"
        srv.prefix_cache.clear()
        if srv.allocator.num_free != srv.allocator.num_usable:
            raise RuntimeError(f"ragged bench leaked pages in {name} mode")
        return srv, reqs, dt

    seq, reqs_seq, t_seq = serve("seq", prefill_batch=1, fused="off")
    bat, reqs_bat, _ = serve("bat", prefill_batch=batch, fused="off")
    fus, reqs_fus, t_fus = serve("fus", fused="on")

    agree_fus = _agreement(reqs_seq, reqs_fus)
    agree_bat = _agreement(reqs_seq, reqs_bat)
    free = None
    if teacher_force:
        free = (agree_fus, agree_bat)
        ref = _tokens(reqs_seq)
        agree_fus = _agreement(reqs_seq,
                               serve("fus", ref, fused="on")[1])
        agree_bat = _agreement(reqs_seq, serve("bat", ref,
                                               prefill_batch=batch,
                                               fused="off")[1])
    if min(agree_fus, agree_bat) < 0.9:
        raise RuntimeError(f"ragged modes broke decode: fused {agree_fus:.1%}"
                           f" / batched {agree_bat:.1%} token agreement")
    if fus.program_launches != fus.cycles:
        raise RuntimeError(
            f"fused serving launched {fus.program_launches} programs over "
            f"{fus.cycles} cycles; the contract is exactly one per cycle")
    if fus.program_launches >= seq.program_launches:
        raise RuntimeError(
            f"fused serving failed to reduce total programs on the "
            f"saturated trace: {seq.program_launches} separate vs "
            f"{fus.program_launches} fused")
    if bat.prefill_forwards >= seq.prefill_forwards:
        raise RuntimeError(
            f"prefix-aware wave dedupe failed to reduce prefill forwards: "
            f"{seq.prefill_forwards} sequential vs "
            f"{bat.prefill_forwards} batched under the prefix cache")
    slo = fus.tracer.slo_summary()
    assert (fus.metrics.counter("serve.program_launches").value
            == fus.metrics.counter("serve.cycles").value)
    trace_path = _export_trace(fus, "trace_ragged.json")
    res = {
        "requests": requests, "batch": batch, "sys_len": sys_len,
        "max_new": max_new,
        "programs_separate": seq.program_launches,
        "programs_fused": fus.program_launches,
        "cycles_fused": fus.cycles,
        "program_reduction": seq.program_launches / fus.program_launches,
        "decode_steps_separate": seq.decode_steps,
        "decode_steps_fused": fus.decode_steps,
        "prefill_forwards_sequential": seq.prefill_forwards,
        "prefill_forwards_batched": bat.prefill_forwards,
        "wave_dedup_pages": bat.wave_dedup_pages + fus.wave_dedup_pages,
        "token_agreement_fused": agree_fus,
        "token_agreement_batched": agree_bat,
        "wall_s_separate": t_seq, "wall_s_fused": t_fus,
        "goodput": slo["goodput"],
        "ttft_p50_s": slo["ttft_p50_s"], "ttft_p99_s": slo["ttft_p99_s"],
        "tpot_p50_s": slo["tpot_p50_s"], "tpot_p99_s": slo["tpot_p99_s"],
        "trace_path": trace_path, "trace_events": len(fus.tracer.events),
    }
    if free is not None:
        res["token_agreement_fused_free_running"] = free[0]
        res["token_agreement_batched_free_running"] = free[1]
    if verbose:
        note = ("" if free is None else
                f" (teacher-forced; free-running {free[0]:.1%} / "
                f"{free[1]:.1%})")
        print(f"[ragged] {requests} queued shared-prefix requests "
              f"(batch={batch}): {res['programs_separate']} -> "
              f"{res['programs_fused']} programs "
              f"({res['program_reduction']:.2f}x, one per cycle), "
              f"prefill fwd {res['prefill_forwards_sequential']} -> "
              f"{res['prefill_forwards_batched']} (wave dedupe), "
              f"agreement fused {agree_fus:.1%} / batched {agree_bat:.1%}"
              f"{note}")
        print(f"  slo (fused): goodput {res['goodput']:.2f}, ttft p50 "
              f"{1e3 * (res['ttft_p50_s'] or 0):.1f} ms / p99 "
              f"{1e3 * (res['ttft_p99_s'] or 0):.1f} ms, tpot p50 "
              f"{1e3 * (res['tpot_p50_s'] or 0):.2f} ms; "
              f"{res['trace_events']} trace events -> "
              f"{Path(trace_path).name if trace_path else None}")
    save_json("ragged_serve.json", res)
    return res


WORKLOADS = {"prefix": run_prefix, "overcommit": run_overcommit,
             "adapt": run_adapt, "ragged": run_ragged}


def _point(arch, fast, summary) -> dict:
    return {"when": time.strftime("%Y-%m-%d %H:%M:%S"), "arch": arch,
            "fast": fast, "summary": summary}


def run(cfg, model, *, arch="qwen2-72b", requests=10, batch=4, max_len=64,
        page_size=16, verbose=True, fast=False, workload="all",
        teacher_force=False, vocab=None):
    """One workload by name, or ``mixed`` (the five rows and batched
    prefill), or ``all`` (mixed, prefix and overcommit); each run appends
    one trajectory point."""
    kw = dict(verbose=verbose, fast=fast, teacher_force=teacher_force,
              vocab=vocab)
    if workload in WORKLOADS:
        res = WORKLOADS[workload](cfg, model, arch=arch, **kw)
        path = common.append_trajectory(_point(arch, fast,
                                               {workload: res}))
        if verbose:
            print(f"  trajectory point appended to {path.name}")
        return res
    if workload not in ("all", "mixed"):
        raise ValueError(f"unknown workload {workload!r}")
    if fast:   # one small iteration a configuration, no warm-up
        requests, batch, max_len, page_size = 2, 2, 32, 8
    # the pool holds the trace's worst concurrent demand, not
    # batch x max_len: the allocation a dense layout cannot shrink
    per_slot = -(-(MAX_PROMPT + max_len // 2) // page_size)
    num_pages = 1 + batch * per_slot
    row_kw = dict(requests=requests, batch=batch, max_len=max_len,
                  warmup=not fast, vocab=vocab)
    paged = dict(page_size=page_size, num_pages=num_pages)
    rows = [
        bench_one(cfg, model, name="dense-fp32", kv_bits=0, page_size=0,
                  num_pages=None, **row_kw),
        bench_one(cfg, model, name="paged-int8-step", kv_bits=8,
                  prefill="stepwise", **paged, **row_kw),
        bench_one(cfg, model, name="paged-int8", kv_bits=8, **paged,
                  **row_kw),
        bench_one(cfg, model, name="paged-int4", kv_bits=4, **paged,
                  **row_kw),
        bench_one(cfg, model, name="paged-int8-kernel", kv_bits=8,
                  attn_impl="kernel", **paged, **row_kw),
    ]
    base = rows[0]["kv_bytes_per_token_slot"]
    for r in rows:
        r["footprint_reduction_vs_fp32"] = base / r["kv_bytes_per_token_slot"]
    step, bucketed = rows[1], rows[2]
    summary = {
        "prefill_forwards_stepwise": step["prefill_forwards"],
        "prefill_forwards_bucketed": bucketed["prefill_forwards"],
        "prefill_forwards_reduction": (
            step["prefill_forwards"] / max(bucketed["prefill_forwards"], 1)),
        "prefill_latency_ms_stepwise": step["prefill_latency_ms"],
        "prefill_latency_ms_bucketed": bucketed["prefill_latency_ms"],
        "tokens_per_s": {r["name"]: r["tokens_per_s"] for r in rows},
        "kv_bytes_per_token_slot": {r["name"]: r["kv_bytes_per_token_slot"]
                                    for r in rows},
    }
    summary["batched_prefill"] = run_batched_prefill(cfg, model, **kw)
    if verbose:
        # the dense row stores K/V in the model's dtype: the ratio's base
        base_dtype = str(cfg.torch_dtype).replace("torch.", "")
        print(f"[paged_serve] arch={arch} batch={batch} max_len={max_len} "
              f"page_size={page_size} layers={cfg.num_layers} "
              f"d_model={cfg.d_model} {cfg.dtype}")
        for r in rows:
            print(f"  {r['name']:17s} {r['tokens_per_s']:8.1f} tok/s  "
                  f"prefill {r['prefill_forwards']:3d} fwd "
                  f"{r['prefill_latency_ms']:7.1f} ms/req  "
                  f"{r['kv_bytes_per_token_slot']:9.1f} B/token-slot "
                  f"({r['footprint_reduction_vs_fp32']:4.1f}x vs dense "
                  f"{base_dtype})  cache {r['kv_cache_mib']:8.2f} MiB")
        print(f"  prefill forwards: {summary['prefill_forwards_stepwise']} "
              f"(stepwise) -> {summary['prefill_forwards_bucketed']} "
              f"(bucketed), "
              f"{summary['prefill_forwards_reduction']:.1f}x fewer")
    if workload == "all":
        prefix = run_prefix(cfg, model, arch=arch, **kw)
        summary["prefix"] = {
            k: prefix[k] for k in
            ("prefix_hit_rate", "prefix_token_hit_rate",
             "prefill_forwards_off", "prefill_forwards_on",
             "prefill_forwards_saved", "prefill_forwards_reduction",
             "cow_copies", "evictions", "kv_at_rest_bytes",
             "profile_bytes_vs_int8", "token_agreement_on_vs_off")}
        over = run_overcommit(cfg, model, arch=arch, **kw)
        summary["overcommit"] = {
            k: over[k] for k in
            ("overcommit_ratio", "completed", "rejected", "preemptions",
             "resumes", "realias_skipped_demotions", "ooo_admissions",
             "demotions", "promotions",
             "host_peak_pages", "kv_inventory",
             "prefix_hit_rate_restored", "prefix_hit_rate_warm",
             "token_agreement_vs_uninterrupted",
             "goodput", "deadline_misses", "ttft_p50_s", "ttft_p99_s",
             "tpot_p50_s", "tpot_p99_s")}
    out = {"arch": arch, "batch": batch, "max_len": max_len,
           "page_size": page_size, "rows": rows, "summary": summary}
    save_json("paged_serve.json", out)
    path = common.append_trajectory(_point(arch, fast, summary))
    if verbose:
        print(f"  trajectory point appended to {path.name}")
    return out


# ---------------------------------------------------------------------------
# the host counters of each workload's result
# ---------------------------------------------------------------------------
# the fields that count host events (forwards, pages, hits, preemptions,
# programs): equal token traces make them equal whatever the model's
# widths or the machine, so a smoke config on the CPU predicts them for a
# full-width model on the card. Every name is looked up: a renamed field
# raises instead of dropping out of a comparison.
ROW_COUNTERS = ("attn_impl", "prefill", "prefill_forwards", "token_capacity")
HOST_COUNTERS = {
    "mixed": ("summary.prefill_forwards_stepwise",
              "summary.prefill_forwards_bucketed",
              "summary.batched_prefill.prefill_forwards_sequential",
              "summary.batched_prefill.prefill_forwards_batched"),
    "prefix": ("prefix_hit_rate", "prefix_token_hit_rate",
               "prefix_hit_tokens", "cow_copies", "evictions",
               "prefill_forwards_off", "prefill_forwards_on",
               "prefill_forwards_saved"),
    "overcommit": ("offered_pages", "completed", "rejected", "preemptions",
                   "resumes", "realias_skipped_demotions", "ooo_admissions",
                   "demotions", "promotions", "host_peak_pages",
                   "prefix_hit_rate_cold", "prefix_hit_rate_warm",
                   "prefix_hit_rate_restored", "snapshot_pages",
                   "restored_pages", "goodput", "deadline_misses",
                   "trace_events"),
    "adapt": ("requants", "deepens", "tier_promotions", "tier_peak_pages",
              "requants_at_first_demotion", "demotions_off", "demotions_on",
              "evictions_off", "evictions_on", "tokens_before_host_on"),
    "ragged": ("programs_separate", "programs_fused", "cycles_fused",
               "decode_steps_separate", "decode_steps_fused",
               "prefill_forwards_sequential", "prefill_forwards_batched",
               "wave_dedup_pages", "goodput", "trace_events"),
    # traffic.run_serve's; the predictor-on arm's admissions follow the
    # wall clock (its TPOT feature), the off arm's do not
    "traffic": ("trace.requests", "trace.fingerprint",
                "predictor_off.goodput", "predictor_off.deadline_misses",
                "predictor_on.goodput", "predictor_on.deadline_misses",
                "predictor_on.predictor_updates",
                "predictor_on.predictor_gated",
                "predictor_on.pager_demotions",
                "predictor_on.pager_promotions"),
    # traffic.run_replicas's
    "replicas": ("trace.requests", "trace.fingerprint",
                 "one_replica.goodput", "two_replica.goodput",
                 "two_replica.routed", "two_replica.routed_per_replica",
                 "two_replica.affinity_hits", "two_replica.rebalanced",
                 "two_replica.shared_prefix_pages"),
}


def _field(res, path: str):
    for key in path.split("."):
        res = res[key]
    return res


def host_counters(workload: str, res: dict, *, wall_clock=True) -> dict:
    """``HOST_COUNTERS[workload]`` of a workload's result, by dotted path
    (and, for mixed, ``ROW_COUNTERS`` of each row by its name);
    ``wall_clock=False`` leaves out the predictor-on arm of traffic."""
    out = {p: _field(res, p) for p in HOST_COUNTERS[workload]
           if wall_clock or not p.startswith("predictor_on.")}
    for row in res.get("rows", ()) if workload == "mixed" else ():
        out.update({f"rows.{row['name']}.{k}": row[k] for k in ROW_COUNTERS})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--fast", action="store_true",
                    help="CI smoke: tiny trace, single iteration per config")
    ap.add_argument("--workload",
                    choices=["all", "mixed", "prefix", "overcommit",
                             "adapt", "ragged"],
                    default="all")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_smoke_config(args.arch)
    model = init_model(cfg, seed=0, device=resolve_device(args.device))
    return run(cfg, model, arch=args.arch, requests=args.requests,
               batch=args.batch, max_len=args.max_len,
               page_size=args.page_size, fast=args.fast,
               workload=args.workload)


if __name__ == "__main__":
    main()
