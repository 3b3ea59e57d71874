"""Port parity, the SLO scheduler and preemption: the reference's scheduler
tests (``tests/test_scheduler.py``) on the port. The policy units
(``request_key``, the stable sort, ``choose_victims``) decide as the
reference's do; FIFO skips a never-fit head, SLO mode records rejects,
admits past a deferred head, preempts into the host tier, re-aliases cached
prompt pages and releases a rejected victim's parked state; the server's
host counters equal the reference server's on the same three requests.

Preempt/resume is bitwise inside the port at kv-bits 0, 8 and 4, prefix
cache off and on. The reference's identity script compares a
``batch_size=1`` preempting server with a ``batch_size=3`` uninterrupted
one; on the CPU the port's one-row products round differently from the
same row among several, so the port's uninterrupted run is a roomy
``batch_size=1`` FIFO server: equal batch sizes, no preemption."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, torch_model  # noqa: E402

from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.core.paged_kv import OutOfPagesError  # noqa: E402
from repro_torch.launch import scheduler as tsched  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402

CPU = torch.device("cpu")
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=2)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def _req(cls, rid, *, priority=0, deadline=None, arrive=0, prompt_len=4,
         max_new=4):
    return cls(rid, (np.arange(prompt_len) % 7).astype(np.int32), max_new,
               priority=priority, deadline_step=deadline, arrive_step=arrive)


# ---------------------------------------------------------------------------
# policy units, decided as the reference decides them
# ---------------------------------------------------------------------------
def test_request_key_priority_then_deadline_then_arrival():
    for cls, mod in ((Request, tsched), (JRequest, jsched)):
        reqs = [_req(cls, 4, arrive=7), _req(cls, 3),
                _req(cls, 2, deadline=99), _req(cls, 1, deadline=10),
                _req(cls, 0, priority=5)]
        assert [r.rid for r in sorted(reqs, key=mod.request_key)] == \
            [0, 1, 2, 3, 4]
        assert [mod.request_key(r) for r in reqs] == \
            [jsched.request_key(r) for r in reqs]


def test_sort_queue_is_stable_for_ties():
    a, b = _req(Request, 1), _req(Request, 2)
    a.rid = b.rid = 1                       # a full tie on every key field
    q = [a, b]
    tsched.SLOScheduler().sort_queue(q)
    assert q[0] is a and q[1] is b


@pytest.mark.parametrize("shortfall", [0, 2, 4, 99])
def test_choose_victims_matches_reference(shortfall):
    outs = []
    for cls, mod in ((Request, tsched), (JRequest, jsched)):
        sched = mod.SLOScheduler(mod.SchedPolicy(max_preempt_per_admit=2))
        urgent = _req(cls, 0, priority=5)
        running = [(0, _req(cls, 1), 0), (1, _req(cls, 3, priority=3), 0),
                   (2, _req(cls, 2, arrive=3), 0)]
        gains = {0: 2, 1: 2, 2: 2}
        outs.append((
            sched.choose_victims(urgent, running, shortfall, gains.get),
            sched.choose_victims(urgent, running, shortfall, gains.get,
                                 limit=1),
            sched.choose_victims(_req(cls, 9, priority=5),
                                 [(0, urgent, 0)], shortfall, gains.get),
            mod.SLOScheduler(mod.SchedPolicy(preempt=False)).choose_victims(
                urgent, running, shortfall, gains.get)))
    assert outs[0] == outs[1]
    if shortfall == 4:
        assert outs[0][0] == [2, 0]        # least urgent first, until met
    if shortfall == 99:
        assert outs[0][0] == []            # half a preemption buys nothing


# ---------------------------------------------------------------------------
# FIFO and SLO admission
# ---------------------------------------------------------------------------
def test_fifo_skips_permanently_too_large_head(models):
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, batch_size=2, max_len=64, kv_bits=8,
                        page_size=8, num_pages=5, device=CPU)
    rng = np.random.default_rng(0)
    huge = Request(0, rng.integers(0, tcfg.vocab_size, 30).astype(np.int32),
                   30)
    ok = [Request(i, rng.integers(0, tcfg.vocab_size, 6).astype(np.int32), 6)
          for i in (1, 2)]
    with pytest.raises(OutOfPagesError) as ei:
        srv.run([huge] + ok)
    assert ei.value.rid == 0 and ei.value.needed > ei.value.total
    assert isinstance(huge.error, OutOfPagesError) and huge.done
    assert huge.out == []
    assert all(r.done and len(r.out) == 6 and r.error is None for r in ok)
    assert srv.allocator.num_free == srv.allocator.num_usable


def test_slo_records_reject_instead_of_raising(models):
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, batch_size=2, max_len=64, kv_bits=8,
                        page_size=8, num_pages=5, sched="slo", device=CPU)
    rng = np.random.default_rng(0)
    huge = Request(0, rng.integers(0, tcfg.vocab_size, 30).astype(np.int32),
                   30)
    ok = Request(1, rng.integers(0, tcfg.vocab_size, 6).astype(np.int32), 6)
    assert srv.run([huge, ok]) is not None
    assert isinstance(huge.error, OutOfPagesError)
    assert ok.done and len(ok.out) == 6 and ok.error is None
    assert srv.rejected == [huge]
    assert srv.metrics.value("sched.rejects") == 1


def _ooo_trace(cls, vocab):
    rng = np.random.default_rng(1)
    return [cls(0, rng.integers(0, vocab, 8).astype(np.int32), 16),
            cls(1, rng.integers(0, vocab, 12).astype(np.int32), 20),
            cls(2, rng.integers(0, vocab, 4).astype(np.int32), 4,
                arrive_step=2)]


@pytest.mark.parametrize("window", [4, 0])
def test_slo_admits_small_request_past_deferred_head(models, window):
    """A head that must wait for pages no longer blocks a small request
    behind it (within the admit window); window 0 is priority-sorted
    FIFO. Defers and out-of-order admissions equal the reference's."""
    jcfg, tcfg, jparams, model = models
    kw = dict(batch_size=2, max_len=64, kv_bits=8, page_size=8, num_pages=7,
              sched="slo", admit_window=window)
    srv = BatchedServer(tcfg, model, device=CPU, **kw)
    reqs = srv.run(_ooo_trace(Request, tcfg.vocab_size))
    assert all(r.done and r.error is None for r in reqs)
    assert (srv.scheduler.ooo_admissions >= 1) == (window > 0)
    assert srv.allocator.num_free == srv.allocator.num_usable
    jsrv = JServer(jcfg, jparams, **kw)
    jsrv.run(_ooo_trace(JRequest, jcfg.vocab_size))
    assert (srv.scheduler.ooo_admissions, srv.metrics.value("sched.defers"),
            srv.decode_steps) == \
        (jsrv.scheduler.ooo_admissions, jsrv.metrics.value("sched.defers"),
         jsrv.decode_steps)


# ---------------------------------------------------------------------------
# preemption
# ---------------------------------------------------------------------------
def _preempt_pair(cls, vocab, seed=2):
    rng = np.random.default_rng(seed)
    low = cls(0, rng.integers(0, vocab, 9).astype(np.int32), 16, priority=0)
    hi = cls(1, rng.integers(0, vocab, 9).astype(np.int32), 6, priority=5,
             arrive_step=4, deadline_step=20)
    return [low, hi]


def test_preemption_demotes_resumes_and_completes(models):
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, batch_size=1, max_len=48, kv_bits=4,
                        page_size=8, num_pages=4, kv_offload="host",
                        sched="slo", device=CPU)
    low, hi = srv.run(_preempt_pair(Request, tcfg.vocab_size))
    assert low.done and hi.done and low.preemptions >= 1
    assert len(low.out) == 16 and len(hi.out) == 6
    assert srv.preempt_count == srv.resume_count >= 1
    assert srv.host_store.num_pages == 0
    assert srv.allocator.num_free == srv.allocator.num_usable
    assert low._paused is None and low.error is None


def test_preempt_realias_skips_host_copies(models):
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, batch_size=1, max_len=48, kv_bits=8,
                        page_size=8, num_pages=5, kv_offload="host",
                        sched="slo", prefix_cache="on", device=CPU)
    low, hi = srv.run(_preempt_pair(Request, tcfg.vocab_size))
    assert low.done and hi.done and low.preemptions >= 1
    assert srv.preempt_count == srv.resume_count >= 1
    assert srv.realias_skipped >= 1
    assert srv.host_store.num_pages == 0
    assert srv.release_prefix_cache() == 0
    assert srv.allocator.num_free == srv.allocator.num_usable


def test_reject_before_resume_releases_pins_and_host_pages(models):
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, batch_size=1, max_len=48, kv_bits=8,
                        page_size=8, num_pages=8, kv_offload="host",
                        sched="slo", prefix_cache="on", prefill_batch=1,
                        kv_scale="page", device=CPU)
    rng = np.random.default_rng(3)
    req = Request(0, rng.integers(0, tcfg.vocab_size, 12).astype(np.int32),
                  8)
    jobs = []
    srv._admit_slo([req], jobs)
    assert srv.slots[0] is req and not jobs
    victim = srv._preempt_slot(0)
    assert {k for k, _ in victim._paused.entries} == {"alias", "host"}
    assert srv.host_store.num_pages >= 1
    srv._reject([victim], 0, RuntimeError("cancelled before resume"))
    assert victim.done and victim._paused is None
    assert srv.host_store.num_pages == 0
    assert srv.release_prefix_cache() == 0
    assert srv.allocator.num_free == srv.allocator.num_usable


def test_preempt_requires_host_offload(models):
    jcfg, tcfg, jparams, model = models
    base = dict(batch_size=1, max_len=32, kv_bits=8, page_size=8)
    for kw in (dict(sched="slo", preempt=True),
               dict(kv_offload="host", preempt=True)):
        with pytest.raises(ValueError) as ref:
            JServer(jcfg, jparams, **base, **kw)
        with pytest.raises(ValueError) as port:
            BatchedServer(tcfg, model, device=CPU, **base, **kw)
        assert str(port.value) == str(ref.value)
        assert ("host" if "sched" in kw else "slo") in str(port.value)


def _identity_trace(cls, vocab):
    """The reference identity script's three requests."""
    rng = np.random.default_rng(11)
    low = cls(0, rng.integers(0, vocab, 9).astype(np.int32), 14, priority=0)
    hi = cls(1, rng.integers(0, vocab, 9).astype(np.int32), 5, priority=5,
             arrive_step=4)
    mid = cls(2, rng.integers(0, vocab, 5).astype(np.int32), 6, priority=1,
              arrive_step=8)
    return [low, hi, mid]


_PREEMPT_KW = dict(batch_size=1, max_len=48, page_size=8, num_pages=4,
                   kv_offload="host", sched="slo")


@pytest.mark.parametrize("prefix", ["off", "on"])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_preempt_resume_bitwise_identical(models, kv_bits, prefix):
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, kv_bits=kv_bits, prefix_cache=prefix,
                        device=CPU, **_PREEMPT_KW)
    reqs = srv.run(_identity_trace(Request, tcfg.vocab_size))
    assert srv.preempt_count >= 1, "the trace failed to preempt"
    assert srv.resume_count == srv.preempt_count
    assert all(r.done and r.error is None for r in reqs)
    if prefix == "on":
        assert srv.realias_skipped >= 1
        assert srv.release_prefix_cache() == 0
    assert srv.host_store.num_pages == 0
    ref = BatchedServer(tcfg, model, batch_size=1, max_len=48,
                        kv_bits=kv_bits, page_size=8, device=CPU)
    by_rid = {r.rid: r for r in ref.run(_identity_trace(Request,
                                                        tcfg.vocab_size))}
    assert ref.preempt_count == 0
    for r in reqs:
        assert r.out == by_rid[r.rid].out, (kv_bits, prefix, r.rid)


def _host_counters(srv):
    m = srv.metrics
    out = {"preempt": srv.preempt_count, "resume": srv.resume_count,
           "realias": srv.realias_skipped,
           "prefill_forwards": srv.prefill_forwards,
           "decode_steps": srv.decode_steps,
           "programs": srv.program_launches,
           "allocs": m.value("alloc.allocs"),
           "reclaims": m.value("alloc.reclaims"),
           "defers": m.counter("sched.defers").value,
           "rejects": m.counter("sched.rejects").value,
           "ooo": srv.scheduler.ooo_admissions,
           "host_puts": srv.host_store.puts,
           "host_peak": srv.host_store.peak_pages,
           "host_peak_bytes": srv.host_store.peak_bytes}
    if srv.prefix_cache is not None:
        out.update({k: v for k, v in srv.prefix_cache.stats().items()
                    if k not in ("hit_rate", "token_hit_rate")})
    return out


@pytest.mark.parametrize("prefix", ["off", "on"])
def test_host_counters_match_reference(models, prefix):
    """The three requests through both servers at kv-bits 8: every host
    counter (preemptions, resumes, re-aliased pages, the host tier's
    puts and peak bytes, the prefix cache's) is equal, and the tokens pass
    the reference benches' accuracy gate."""
    jcfg, tcfg, jparams, model = models
    kw = dict(_PREEMPT_KW, kv_bits=8, prefix_cache=prefix)
    jsrv = JServer(jcfg, jparams, **kw)
    jreqs = jsrv.run(_identity_trace(JRequest, jcfg.vocab_size))
    tsrv = BatchedServer(tcfg, model, device=CPU, **kw)
    treqs = tsrv.run(_identity_trace(Request, tcfg.vocab_size))
    assert _host_counters(tsrv) == _host_counters(jsrv)
    assert tsrv.preempt_count >= 1
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                         **GATE)
    assert gate["passed"], gate
