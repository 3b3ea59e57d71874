"""Port parity, serving with the tiered page store: the reference traffic
bench's overload trace (``overload_trace_config(fast=True)``: bursty
arrivals, a deadlined tenant over 2 shared system prompts, a no-deadline
batch tenant) replayed through both servers on the CPU with the prefix
cache on, host offload and SLO scheduling in both pager modes, with the
predictor, and with the quant tier on a float pool: every host counter
(preemptions, resumes, re-aliased pages, pager demotions, promotions,
prefetches and hits, host drops, requantizations, deepens, tier
promotions, defers, rejects, out-of-order admissions, the predictor's
gated admissions, prefill forwards, programs) equals the reference's, and
the tokens pass the accuracy gate against it. Also the reference's
``test_kv_adapt_*`` cases (``tests/test_serve_fast.py``), the tracer's
integrity over a preemption (``tests/test_telemetry.py``) and the CLI
(server-level snapshot exchange is in ``test_torch_page_store.py``)."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, torch_model  # noqa: E402

from benchmarks import traffic as jbench  # noqa: E402
from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.core.traffic import generate_trace as jgenerate  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.benchmarks import traffic as tbench  # noqa: E402
from repro_torch.core.traffic import generate_trace  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro.runtime import telemetry as jtelemetry  # noqa: E402
from repro_torch.runtime import telemetry as ttelemetry  # noqa: E402
from repro_torch.runtime.telemetry import PAGER_TID  # noqa: E402

CPU = torch.device("cpu")
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=2)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def host_counters(srv) -> dict:
    """Every counter of the tiered serving path that depends on tokens and
    pages only, not on the model's numbers."""
    m, st = srv.metrics, srv.prefix_cache.stats()
    out = {"preempt_count": srv.preempt_count,
           "resume_count": srv.resume_count,
           "realias_skipped": srv.realias_skipped,
           "host_drops": st["host_drops"], "requants": st["requants"],
           "deepens": st["deepens"],
           "tier_promotions": st["tier_promotions"],
           "prefix_demotions": st["demotions"],
           "prefix_promotions": st["promotions"], "hits": st["hits"],
           "evictions": st["evictions"], "cow_copies": st["cow_copies"],
           "defers": m.counter("sched.defers").value,
           "rejects": m.counter("sched.rejects").value,
           "ooo_admissions": srv.scheduler.ooo_admissions,
           "gated": srv.predictor.gated if srv.predictor else 0,
           "prefill_forwards": srv.prefill_forwards,
           "programs": srv.program_launches,
           "decode_steps": srv.decode_steps,
           "allocs": m.value("alloc.allocs")}
    if srv.pager is not None:
        out.update(demotions=srv.pager.demotions,
                   promotions=srv.pager.promotions,
                   prefetches=srv.pager.prefetches,
                   prefetch_hits=srv.pager.prefetch_hits,
                   host_peak_pages=srv.host_store.peak_pages,
                   host_peak_bytes=srv.host_store.peak_bytes)
    if srv.quant_tier is not None:
        out.update(tier_peak_pages=srv.quant_tier.peak_pages,
                   tier_peak_bytes=srv.quant_tier.peak_bytes)
    return out


_TIER_KW = dict(batch_size=4, max_len=64, page_size=8, num_pages=24,
                prefill_bucket=8, prefix_cache="on", kv_offload="host",
                sched="slo")
_CASES = {
    "int8-sync": dict(kv_bits=8),
    "int8-async": dict(kv_bits=8, pager_async="on"),
    "int8-predictor": dict(kv_bits=8, pager_async="on", predictor="on"),
    "fp-adapt": dict(kv_bits=0, kv_adapt="on", adapt_pages=4),
}


class _FakeClock:
    """Stands in for the ``time`` module a telemetry module sees: each
    ``perf_counter`` call advances a fixed step, so the SLO monitor's
    wall-clock features (TTFT, TPOT and the predictor's TPOT slowdown)
    count the monitor's own calls and not the machine's load."""

    def __init__(self, step: float = 1e-3):
        self.now, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now


@pytest.mark.parametrize("case", list(_CASES))
def test_overload_trace_counters_match_reference(models, case, monkeypatch):
    """Both servers' telemetry reads its own fake clock (one a package),
    so the predictor's gated admissions are decided by the trace and not
    by how busy the machine is."""
    monkeypatch.setattr(jtelemetry, "time", _FakeClock())
    monkeypatch.setattr(ttelemetry, "time", _FakeClock())
    jcfg, tcfg, jparams, model = models
    kw = dict(_TIER_KW, **_CASES[case])
    jsrv = JServer(jcfg, jparams, **kw)
    jreqs = jsrv.run(jbench.to_requests(jgenerate(
        jbench.overload_trace_config(jcfg.vocab_size, fast=True))))
    tsrv = BatchedServer(tcfg, model, device=CPU, **kw)
    treqs = tsrv.run(tbench.to_requests(generate_trace(
        tbench.overload_trace_config(tcfg.vocab_size, fast=True))))
    got, want = host_counters(tsrv), host_counters(jsrv)
    assert got == want
    assert got["preempt_count"] >= 1 and got["demotions"] >= 1
    if case == "fp-adapt":
        assert got["requants"] >= 1 and got["deepens"] >= 1
        h = tsrv.metrics.histogram
        assert h("tier.requantize_s").count >= got["requants"]
        assert h("tier.deepen_s").count >= got["deepens"]
        assert h("tier.restore_s").count == got["tier_promotions"]
    if case == "int8-predictor":
        assert got["gated"] >= 1
    assert all(r.done and r.error is None for r in treqs)
    assert [len(r.out) for r in treqs] == [len(r.out) for r in jreqs]
    gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                         **GATE)
    assert gate["passed"], gate
    inv, jinv = tsrv.kv_inventory(), jsrv.kv_inventory()
    for key in ("host_bytes", "host_pages", "host_by_container",
                "tier_bytes", "tier_pages", "tier_by_container",
                "device_by_container"):
        assert inv[key] == jinv[key], key
    assert tsrv.release_prefix_cache() == jsrv.release_prefix_cache() == 0
    assert tsrv.host_store.num_pages == 0
    assert tsrv.allocator.num_free == tsrv.allocator.num_usable


def test_async_pager_equals_sync_inside_the_port(models):
    """The pager moves bytes and decides nothing: async and sync serve the
    same tokens with the same counters (the async run's transfers show on
    the tracer's pager track)."""
    _, tcfg, _, model = models
    outs, counts = [], []
    for mode in ("off", "on"):
        srv = BatchedServer(tcfg, model, device=CPU, kv_bits=8,
                            pager_async=mode, metrics="on", **_TIER_KW)
        reqs = srv.run(tbench.to_requests(generate_trace(
            tbench.overload_trace_config(tcfg.vocab_size, fast=True))))
        outs.append([r.out for r in reqs])
        c = host_counters(srv)
        c.pop("prefetches")
        c.pop("prefetch_hits")
        counts.append(c)
        names = {e["name"] for e in srv.tracer.events
                 if e.get("tid") == PAGER_TID and e["ph"] == "X"}
        assert "pager.demote" in names
        if mode == "on":
            assert srv.metrics.histogram("pager.offload_s").count >= 1
            # the staged uploads of preempted requests' pages are used
            assert srv.pager.staged_resumes >= 1
    assert outs[0] == outs[1] and counts[0] == counts[1]


# ---------------------------------------------------------------------------
# the reference's kv-adapt cases
# ---------------------------------------------------------------------------
def _adapt_trace(vocab):
    sys_prompt = np.random.default_rng(19).integers(0, vocab, 9).astype(
        np.int32)
    r = np.random.default_rng(29)
    reqs = [Request(i, np.concatenate(
        [sys_prompt, r.integers(0, vocab, 2 + i).astype(np.int32)]),
        4 + i % 3) for i in range(4)]
    reqs.append(Request(4, reqs[0].prompt.copy(), 6))
    return reqs


_ADAPT_BASE = dict(batch_size=2, max_len=32, page_size=8, prefill="bucketed",
                   prefill_bucket=8, prefill_batch=1, prefix_cache="on",
                   device=CPU)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_kv_adapt_off_matches_seed(models, kv_bits):
    _, tcfg, _, model = models
    seed = BatchedServer(tcfg, model, kv_bits=kv_bits, **_ADAPT_BASE)
    off = BatchedServer(tcfg, model, kv_bits=kv_bits, kv_adapt="off",
                        **_ADAPT_BASE)
    for a, b in zip(seed.run(_adapt_trace(tcfg.vocab_size)),
                    off.run(_adapt_trace(tcfg.vocab_size))):
        assert a.out == b.out, (kv_bits, a.rid)
    assert off.quant_tier is None


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_kv_adapt_on_is_noop_without_pressure(models, kv_bits):
    _, tcfg, _, model = models
    off = BatchedServer(tcfg, model, kv_bits=kv_bits, kv_adapt="off",
                        **_ADAPT_BASE)
    on = BatchedServer(tcfg, model, kv_bits=kv_bits, kv_adapt="on",
                       **_ADAPT_BASE)
    for a, b in zip(off.run(_adapt_trace(tcfg.vocab_size)),
                    on.run(_adapt_trace(tcfg.vocab_size))):
        assert a.out == b.out, (kv_bits, a.rid)
    st = on.prefix_cache.stats()
    assert st["requants"] == 0 and st["tier_promotions"] == 0, st
    assert on.quant_tier.num_pages == 0 and on.quant_tier.nbytes == 0
    assert on.release_prefix_cache() == 0
    assert on.allocator.num_free == on.allocator.num_usable


def _pressure_trace(cls, vocab):
    rng = np.random.default_rng(31)
    reqs = []
    for g in range(4):              # 4 tenants, distinct 8-token prefixes
        sys_p = rng.integers(0, vocab, 8).astype(np.int32)
        sfx = rng.integers(0, vocab, 3).astype(np.int32)
        reqs.append(cls(g, np.concatenate([sys_p, sfx]), 4,
                        arrive_step=2 * g))
    return reqs, rng


def test_kv_adapt_requantizes_under_pressure(models):
    jcfg, tcfg, jparams, model = models
    kw = dict(batch_size=2, max_len=64, kv_bits=8, page_size=4,
              num_pages=10, prefill="bucketed", prefill_bucket=8,
              prefill_batch=1, prefix_cache="on", kv_offload="host",
              kv_adapt="on", adapt_pages=36)
    srv = BatchedServer(tcfg, model, device=CPU, **kw)
    reqs, rng = _pressure_trace(Request, tcfg.vocab_size)
    srv.run(reqs)
    assert all(r.done and r.error is None and len(r.out) == 4 for r in reqs)
    st = srv.prefix_cache.stats()
    assert st["requants"] >= 1, st
    if st["demotions"]:
        assert st["requants_at_first_demotion"] >= 1, st
    assert srv.quant_tier.peak_pages >= 1
    jsrv = JServer(jcfg, jparams, **kw)
    jsrv.run(_pressure_trace(JRequest, jcfg.vocab_size)[0])
    jst = jsrv.prefix_cache.stats()
    assert {k: st[k] for k in st if "rate" not in k} == \
        {k: jst[k] for k in jst if "rate" not in k}
    assert srv.quant_tier.peak_bytes == jsrv.quant_tier.peak_bytes
    verdict, info = srv._admission_plan(
        Request(99, rng.integers(0, tcfg.vocab_size, 40).astype(np.int32),
                20))
    assert verdict == "reject"
    assert info["err"].requantizable == \
        srv.prefix_cache.requantizable_pages() >= 1
    assert srv.release_prefix_cache() == 0
    assert srv.quant_tier.num_pages == 0 and srv.quant_tier.nbytes == 0
    assert srv.host_store.num_pages == 0
    assert srv.allocator.num_free == srv.allocator.num_usable


@pytest.mark.parametrize("kw", [
    dict(kv_adapt="maybe"),
    dict(kv_bits=8, page_size=8, kv_adapt="on"),
    dict(kv_adapt="on"),
    dict(kv_bits=8, page_size=8, prefix_cache="on", kv_adapt="on",
         adapt_floor_bits=6),
    dict(kv_bits=4, page_size=8, prefix_cache="on", kv_adapt="on"),
    dict(kv_offload="disk", page_size=8),
    dict(kv_offload="host")])
def test_kv_adapt_and_offload_validation(models, kw):
    jcfg, tcfg, jparams, model = models
    with pytest.raises(ValueError) as ref:
        JServer(jcfg, jparams, batch_size=2, max_len=32, **kw)
    with pytest.raises(ValueError) as port:
        BatchedServer(tcfg, model, batch_size=2, max_len=32, device=CPU,
                      **kw)
    assert str(port.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the tracer over a preemption
# ---------------------------------------------------------------------------
def _disjoint_or_nested(spans, eps=0.5):
    ivs = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans]
    for i, (a0, a1, an) in enumerate(ivs):
        for b0, b1, bn in ivs[i + 1:]:
            assert (a1 <= b0 + eps or b1 <= a0 + eps
                    or (b0 <= a0 + eps and a1 <= b1 + eps)
                    or (a0 <= b0 + eps and b1 <= a1 + eps)), (an, bn)


def test_trace_integrity_preempt_resume(models, tmp_path):
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, batch_size=1, max_len=48, kv_bits=4,
                        page_size=8, num_pages=4, kv_offload="host",
                        sched="slo", metrics="on", device=CPU)
    rng = np.random.default_rng(2)
    low = Request(0, rng.integers(0, tcfg.vocab_size, 9).astype(np.int32),
                  16)
    hi = Request(1, rng.integers(0, tcfg.vocab_size, 9).astype(np.int32),
                 6, priority=5, arrive_step=4, deadline_step=20)
    srv.run([low, hi])
    assert low.done and hi.done and srv.preempt_count >= 1
    trace = json.loads(json.dumps(srv.tracer.chrome_trace()))
    events = trace["traceEvents"]
    assert {e["ph"] for e in events} <= {"X", "i", "M"}
    xs = [e for e in events if e["ph"] == "X"]
    for e in events:
        assert e["pid"] == 0
        if e["ph"] != "M":
            assert e["ts"] >= 0 and e.get("dur", 0) >= 0
    assert {"decode_span", "admission"} <= {e["name"] for e in xs
                                            if e["tid"] == 0}
    for tid in {e["tid"] for e in xs}:
        _disjoint_or_nested([e for e in xs if e["tid"] == tid])
    for rid in (0, 1):
        inst = {e["name"]: e["ts"] for e in events
                if e["ph"] == "i" and e["tid"] == 1 + rid}
        assert inst["arrive"] <= inst["admit"] <= inst["first_token"] \
            <= inst["finish"]
    names = {e["args"]["name"] for e in events if e["ph"] == "M"
             and e["name"] == "thread_name"}
    assert {"engine", "req 0", "req 1"} <= names
    victim = [e for e in xs if e["tid"] == 1]
    offloads = [e for e in victim if e["name"] == "offload"]
    resumes = [e for e in victim if e["name"] == "resume"]
    assert offloads and resumes
    for o in offloads:
        for r in resumes:
            assert o["ts"] + o["dur"] <= r["ts"] or \
                r["ts"] + r["dur"] <= o["ts"]
    pre = [e["ts"] for e in events if e["ph"] == "i" and e["tid"] == 1
           and e["name"] == "preempt"]
    assert pre and min(pre) <= resumes[0]["ts"]
    stats = {s["rid"]: s for s in srv.tracer.request_stats()}
    assert stats[0]["preemptions"] >= 1 and stats[0]["resumed"] >= 1
    assert stats[0]["tokens"] == 16 and stats[1]["tokens"] == 6
    assert stats[1]["met_deadline"], stats[1]
    slo = srv.tracer.slo_summary()
    assert slo["requests"] == slo["finished"] == 2
    assert slo["preemptions"] == srv.preempt_count and slo["deadlined"] == 1
    path = srv.tracer.export_chrome(str(tmp_path / "t.json"))
    assert json.load(open(path))["traceEvents"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_serves_with_tiers(tmp_path, capsys):
    snap = str(tmp_path / "snap.npz")
    argv = ["--arch", "qwen2-72b", "--smoke", "--device", "cpu",
            "--requests", "8", "--prompt-len", "20", "--max-new", "6",
            "--batch-size", "4", "--max-len", "64", "--page-size", "8",
            "--kv-bits", "8", "--num-pages", "14", "--prefix-cache", "on",
            "--kv-offload", "host", "--host-pages", "64", "--sched", "slo",
            "--admit-window", "2", "--pager-async", "on", "--predictor",
            "on", "--prefix-snapshot", snap]
    reqs = tserve.main(argv)
    assert all(r.done for r in reqs) and os.path.exists(snap)
    out = capsys.readouterr().out
    assert "[serve] host tier:" in out and "snapshotted" in out
    tserve.main(argv + ["--kv-adapt", "on", "--kv-adapt-pages", "8",
                        "--kv-adapt-floor", "4", "--no-preempt"])
    out = capsys.readouterr().out
    assert "restored" in out and "[serve] quant tier:" in out


def test_traffic_replay_serves_the_overload_trace(capsys):
    """The traffic bench's replay: the overload trace through the host
    tier, the async pager and SLO scheduling on the CPU."""
    srv, reqs = tbench.replay_overload(fast=True, device="cpu")
    assert all(r.done and r.error is None for r in reqs)
    assert srv.pager.demotions >= 1 and srv.pager.async_mode
    assert srv.release_prefix_cache() == 0
    out = capsys.readouterr().out
    assert "[serve] host tier:" in out and "[traffic]" in out
