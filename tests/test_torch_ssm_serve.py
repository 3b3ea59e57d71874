"""Port parity, serving the recurrent families: xlstm-350m-smoke (mLSTM
and sLSTM blocks, no attention) and jamba-smoke (Mamba layers, one GQA
layer, eval_all MoE on every other layer), with the JAX init converted
to the port —

* on a shared request list the port's ``BatchedServer`` counts what the
  reference's counts (prefill is stepwise for both archs in both
  packages): xlstm on dense states at kv-bits 0 and 8 and on pages
  (states only, no pool) at kv-bits 8, jamba on a dense
  cache at int8 and on paged int8 and int4 pools through both attention
  routes;
* tokens are held against the reference only where the reference is
  right: each request served alone on a fresh ``batch_size=1`` server
  (the reference carries a slot's recurrent state over from its last
  request and advances the other slots' states during a stepwise
  prefill; the port restarts a slot's states on admission and keeps the
  others', so its batched and sequential tokens equal its alone-served
  tokens bit for bit);
* the reference's refusals for archs that are not attention-only
  (bucketed prefill, the prefix cache, a per-layer KV profile, fused
  rounds) in its exception types and words;
* SLO scheduling with the host tier, with and without preemption: every
  host counter equals the reference server's, and a preempted request
  resumes on the recurrent states it was preempted with (the reference
  resumes it on whatever its new slot holds, ROADMAP queue C item C4), so
  every request gets bit for bit its uninterrupted tokens;
* the CLI serves both archs on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, torch_model  # noqa: E402

from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.core.policy import LayerPolicy as JLayer  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.policy import LayerPolicy, PrecisionPolicy  # noqa
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402

CPU = torch.device("cpu")
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)
XLSTM, JAMBA = "xlstm-350m", "jamba-v0.1-52b"
LENS = [7, 12, 5, 1, 9, 16]

_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jcfg, tcfg, jparams, tree = perturbed_jax_params(arch, seed=2,
                                                         jit=True)
        _MODELS[arch] = jcfg, tcfg, jparams, torch_model(tree, tcfg)
    return _MODELS[arch]


def _requests(cls, vocab, lens=LENS, seed=7, max_new=None):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, L).astype(np.int32),
                max_new or 3 + i % 3) for i, L in enumerate(lens)]


def _counters(srv):
    c = {"prefill_forwards": srv.prefill_forwards,
         "program_launches": srv.program_launches,
         "decode_steps": srv.decode_steps, "cycles": srv.cycles,
         "prefill_tokens": srv.prefill_tokens,
         "prefill_mode": srv.prefill_mode}
    if srv.paged:
        c.update(allocs=srv.metrics.value("alloc.allocs"),
                 free=srv.allocator.num_free, usable=srv.allocator.num_usable)
    return c


def _alone(make, cls, vocab, **kw):
    """Each request served alone: ``make()`` gives a server, fresh or
    restored to its fresh caches."""
    return [make().run([r])[0].out for r in _requests(cls, vocab, **kw)]


_CASES = {
    "xlstm-dense-fp": (XLSTM, dict(kv_bits=0), ("gather",)),
    "xlstm-dense-int8": (XLSTM, dict(kv_bits=8), ("gather",)),
    # pages without a pool: the states only, as the mesh server needs
    "xlstm-paged-int8": (XLSTM, dict(kv_bits=8, page_size=8), ("gather",)),
    "jamba-dense-int8": (JAMBA, dict(kv_bits=8), ("gather",)),
    "jamba-paged-int8": (JAMBA, dict(kv_bits=8, page_size=8),
                         ("gather", "kernel")),
    "jamba-paged-int4": (JAMBA, dict(kv_bits=4, page_size=8),
                         ("gather", "kernel")),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_counters_and_alone_tokens_match_reference(case):
    """Host counters of a batched run equal the reference server's; each
    request served alone on a fresh batch-1 server passes the gate against
    the reference's alone-served tokens, through every route."""
    arch, kw, impls = _CASES[case]
    jcfg, tcfg, jparams, model = _models(arch)
    kw = dict(kw, max_len=48)
    jsrv = JServer(jcfg, jparams, batch_size=3, **kw)
    jsrv.run(_requests(JRequest, jcfg.vocab_size))
    # one batch-1 reference server, its caches restored to the fresh ones
    # before each request (no recompile per request)
    jone = JServer(jcfg, jparams, batch_size=1, **kw)
    fresh = jone.caches

    def jmake():
        jone.caches = fresh
        return jone
    jalone = _alone(jmake, JRequest, jcfg.vocab_size)
    for impl in impls:
        tsrv = BatchedServer(tcfg, model, batch_size=3, attn_impl=impl,
                             device=CPU, **kw)
        treqs = tsrv.run(_requests(Request, tcfg.vocab_size))
        assert all(r.done and r.error is None for r in treqs)
        assert _counters(tsrv) == _counters(jsrv), impl
        assert tsrv.prefill_mode == "stepwise"
        talone = _alone(lambda: BatchedServer(
            tcfg, model, batch_size=1, attn_impl=impl, device=CPU, **kw),
            Request, tcfg.vocab_size)
        gate = accuracy_gate(jalone, talone, **GATE)
        assert gate["passed"], (impl, gate)


C3_LENS = [7, 12, 5]


@pytest.mark.parametrize("arch,kw", [
    (XLSTM, dict(kv_bits=0)), (JAMBA, dict(kv_bits=8)),
    (JAMBA, dict(kv_bits=8, page_size=8))],
    ids=["xlstm-dense", "jamba-dense", "jamba-paged"])
def test_batched_and_sequential_tokens_equal_alone(arch, kw):
    """Inside the port, three requests of 7/12/5 prompt tokens and 6 new,
    served batched at batch size 3 and one after another on one server of
    batch size 3, get bit for bit the tokens each gets alone on a fresh
    server of batch size 3 (equal batch shapes: one-row products round
    differently on the CPU). The reference's serving gives neither: it
    keeps a slot's states from its last request, and its stepwise prefill
    advances the other slots' states."""
    _, tcfg, _, model = _models(arch)
    kw = dict(kw, batch_size=3, max_len=32, device=CPU)
    req = lambda: _requests(Request, tcfg.vocab_size, C3_LENS,  # noqa
                            max_new=6)
    alone = [BatchedServer(tcfg, model, **kw).run([r])[0].out
             for r in req()]
    batched = [r.out for r in BatchedServer(tcfg, model, **kw).run(req())]
    one = BatchedServer(tcfg, model, **kw)
    sequential = [one.run([r])[0].out for r in req()]
    assert batched == alone
    assert sequential == alone


def test_states_restart_on_admission():
    """A slot's recurrent states go back to their initial values on
    admission (the sLSTM stabilizer to -1e30, not 0), and a stepwise
    prefill step leaves the other slots' states as they were."""
    _, tcfg, _, model = _models(XLSTM)
    srv = BatchedServer(tcfg, model, batch_size=2, max_len=32, device=CPU)
    srv.run(_requests(Request, tcfg.vocab_size, [6, 4], max_new=3))
    sl = next(li for li, b in enumerate(model.layers) if b.sig[0] == "slstm")
    assert float(srv.caches[sl]["m"][0].min()) > -1e29   # it moved
    before = {k: t[1].clone() for k, t in srv.caches[sl].items()}
    srv._prefill_slot(0, _requests(Request, tcfg.vocab_size, [1])[0])
    assert torch.all(srv.caches[sl]["m"][0] == -1e30)
    for k in ("h", "c", "n"):
        assert torch.all(srv.caches[sl][k][0] == 0)
    srv._prefill_slot(0, _requests(Request, tcfg.vocab_size, [5])[0])
    for k, t in srv.caches[sl].items():
        assert torch.equal(t[1], before[k]), k


def _profile(P, L, F, n):
    return P(tuple(f"layer_{i:03d}" for i in range(n)),
             tuple(L(None, F(2, 6)) for _ in range(n)))


def test_refusals_use_the_reference_words():
    """Archs that are not attention-only: bucketed prefill, the prefix
    cache, a per-layer KV profile and fused rounds raise the reference's
    ValueError word for word; "auto" serves stepwise."""
    for arch, kw in (
            (JAMBA, dict(page_size=8, prefill="bucketed")),
            (JAMBA, dict(page_size=8, kv_bits=8, prefix_cache="on")),
            (JAMBA, dict(page_size=8, kv_profile="profile")),
            (XLSTM, dict(fused="on")),
            (JAMBA, dict(page_size=8, fused="on"))):
        jcfg, tcfg, jparams, model = _models(arch)
        jkw, tkw = dict(kw), dict(kw)
        if "kv_profile" in kw:
            jkw["kv_profile"] = _profile(JPolicy, JLayer, JFormat,
                                         jcfg.num_layers)
            tkw["kv_profile"] = _profile(PrecisionPolicy, LayerPolicy,
                                         FixedPointFormat, tcfg.num_layers)
        with pytest.raises(ValueError) as ref:
            JServer(jcfg, jparams, batch_size=2, max_len=32, **jkw)
        with pytest.raises(ValueError) as port:
            BatchedServer(tcfg, model, batch_size=2, max_len=32, device=CPU,
                          **tkw)
        assert str(port.value) == str(ref.value), kw
    _, tcfg, _, model = _models(JAMBA)
    srv = BatchedServer(tcfg, model, batch_size=2, max_len=32, page_size=8,
                        device=CPU)
    assert srv.prefill_mode == "stepwise"


def _slo_trace(cls, vocab):
    """The scheduler tests' identity trace and a fourth, most urgent
    request arriving while the third runs: at batch size 1 the second
    preempts the first and the fourth the third."""
    rng = np.random.default_rng(11)
    lens_new_prio_arrive = ((9, 14, 0, 0), (9, 5, 5, 4), (5, 6, 1, 8),
                            (4, 4, 9, 12))
    return [cls(i, rng.integers(0, vocab, L).astype(np.int32), n,
                priority=p, arrive_step=a)
            for i, (L, n, p, a) in enumerate(lens_new_prio_arrive)]


def _slo_counters(srv):
    m = srv.metrics
    return dict(_counters(srv), preempt=srv.preempt_count,
                resume=srv.resume_count, realias=srv.realias_skipped,
                reclaims=m.value("alloc.reclaims"),
                defers=m.counter("sched.defers").value,
                rejects=m.counter("sched.rejects").value,
                ooo=srv.scheduler.ooo_admissions,
                host_puts=srv.host_store.puts,
                host_peak=srv.host_store.peak_pages,
                host_peak_bytes=srv.host_store.peak_bytes)


@pytest.mark.parametrize("preempt", [True, False],
                         ids=["preempt", "no-preempt"])
def test_slo_with_host_tier_resumes_on_parked_states(preempt):
    """jamba-smoke (eval_all) with SLO scheduling and the host tier on a
    4-page pool at batch size 1: with preemption two requests are
    preempted and resumed, without it none; either way every host counter
    equals the reference server's on the same trace, and every request
    gets bit for bit the tokens of a roomy batch-size-1 FIFO server (equal
    batch shapes: one-row products round differently on the CPU). With
    the states left out of the parked state (the reference's behaviour)
    the two resumed requests' tokens differ (checked in a scratch copy)."""
    jcfg, tcfg, jparams, model = _models(JAMBA)
    assert tcfg.moe_mode == "eval_all"
    kw = dict(batch_size=1, max_len=48, page_size=8, num_pages=4,
              kv_bits=8, sched="slo", kv_offload="host", preempt=preempt)
    jsrv = JServer(jcfg, jparams, **kw)
    jreqs = jsrv.run(_slo_trace(JRequest, jcfg.vocab_size))
    srv = BatchedServer(tcfg, model, device=CPU, **kw)
    reqs = srv.run(_slo_trace(Request, tcfg.vocab_size))
    assert all(r.done and r.error is None for r in reqs)
    assert _slo_counters(srv) == _slo_counters(jsrv)
    assert [r.preemptions for r in reqs] == [r.preemptions for r in jreqs]
    assert srv.preempt_count == srv.resume_count == (2 if preempt else 0)
    assert srv.host_store.num_pages == 0
    alone = BatchedServer(tcfg, model, batch_size=1, max_len=48,
                          page_size=8, kv_bits=8, device=CPU)
    want = alone.run(_slo_trace(Request, tcfg.vocab_size))
    assert alone.preempt_count == 0
    for r, w in zip(reqs, want):
        assert r.out == w.out, (preempt, r.rid, r.preemptions)


@pytest.mark.parametrize("argv", [
    ["--arch", XLSTM], ["--arch", XLSTM, "--kv-bits", "8"],
    ["--arch", JAMBA, "--page-size", "8", "--kv-bits", "4",
     "--attn-impl", "kernel"]],
    ids=["xlstm", "xlstm-int8", "jamba-paged-int4"])
def test_cli_serves_on_cpu(argv, capsys):
    reqs = tserve.main(argv + ["--smoke", "--device", "cpu", "--requests",
                               "3", "--batch-size", "2", "--max-new", "3",
                               "--max-len", "32", "--prompt-len", "6"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert "[serve]" in capsys.readouterr().out


def test_configs_keep_their_dispatch():
    """The smoke jamba runs eval_all MoE (exact routing); the published
    one scatter, also stepwise by the server's rule."""
    from repro_torch.configs.registry import get_config
    assert _models(JAMBA)[1].moe_mode == "eval_all"
    assert get_config(JAMBA).moe_mode == "scatter"
