"""Port parity of the multi-replica frontend (``launch/frontend.py``)
against the reference's, on the reference's own weights (the
qwen2-72b smoke config, ``init_model(PRNGKey(0))``) and traces: the
cases of ``tests/test_frontend.py``, each also held against the
reference where the reference computes the same thing.

* A 1-replica ``ReplicaFrontend`` is the port's plain server, bit for
  bit (tokens, done flags, finish steps), at kv-bits 0, 8 and 4, with
  the prefix cache, host tier, async pager and SLO scheduler on.
* Routing: sticky affinity and rebalance past the margin, least-loaded
  key-less routing, each decision equal to the reference's.
* The shared store's round trip (byte for byte) and its namespacing by
  pool geometry; goodput accounting; namespaced registries.
* A 2-replica frontend on the reference test's trace: every counter of
  the frontend and of each namespaced replica equal to the reference's,
  tokens by ``accuracy_gate``.
* ``benchmarks/traffic.py::run_replicas`` at ``--fast``: every field
  that is not a time or an agreement equal to the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _torch_bench import (GATE, comparable, reference_model,  # noqa: E402
                          reference_params, scratch_results)

from benchmarks import traffic as jtraffic  # noqa: E402
from repro.core.traffic import TenantSpec as JTenant  # noqa: E402
from repro.core.traffic import TraceConfig as JTraceConfig  # noqa: E402
from repro.core.traffic import generate_trace as jgenerate  # noqa: E402
from repro.launch import frontend as jfe  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.benchmarks import traffic as ttraffic  # noqa: E402
from repro_torch.benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro_torch.core.traffic import (TenantSpec, TraceConfig,  # noqa: E402
                                      generate_trace)
from repro_torch.launch.frontend import (ReplicaFrontend,  # noqa: E402
                                         SharedPrefixStore,
                                         aggregate_goodput, make_replicas,
                                         merged_snapshot,
                                         requests_from_trace)
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402

CPU = torch.device("cpu")
_COMMON = dict(batch_size=2, max_len=48, page_size=8, num_pages=12,
               prefix_cache="on", kv_offload="host", sched="slo",
               metrics="on", pager_async="on")
# counters only the port keeps (its staged resume uploads)
PORT_ONLY = ("pager.staged_resumes",)


def _trace_cfg(cls, tenant, vocab):
    """The reference test's trace (``tests/test_frontend.py``)."""
    return cls(
        seed=11, horizon=24, rate=0.3, process="bursty", burst_rate=1.2,
        p_enter_burst=0.2, p_exit_burst=0.3, vocab_size=vocab,
        tenants=(tenant("chat", weight=0.7, priority=5,
                        deadline_slack=6, prompt_mean=8.0,
                        prompt_sigma=0.4, prompt_cap=12,
                        max_new_mean=2.5, max_new_sigma=0.4,
                        max_new_cap=4, shared_prefix_len=6,
                        prefix_pool=2),
                 tenant("bulk", weight=0.3, priority=0,
                        deadline_slack=None, prompt_mean=9.0,
                        prompt_sigma=0.4, prompt_cap=14,
                        max_new_mean=6.0, max_new_sigma=0.3,
                        max_new_cap=8)))


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = reference_params()
    cfg, model = reference_model()
    return jcfg, jparams, cfg, model


@pytest.fixture(scope="module")
def traces(models):
    jcfg, _, cfg, _ = models
    return (jgenerate(_trace_cfg(JTraceConfig, JTenant, jcfg.vocab_size)),
            generate_trace(_trace_cfg(TraceConfig, TenantSpec,
                                      cfg.vocab_size)))


def _counters(srv_or_fe) -> dict:
    snap = (merged_snapshot(srv_or_fe) if hasattr(srv_or_fe, "servers")
            else srv_or_fe.metrics.snapshot())
    return {k: v for k, v in snap["counters"].items()
            if not k.endswith("_s") and not k.endswith(PORT_ONLY)}


# ---------------------------------------------------------------------------
# Identity: 1-replica frontend == the plain server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_one_replica_frontend_is_the_plain_server(models, traces, kv_bits):
    _, _, cfg, model = models
    _, trace = traces
    assert trace.requests
    common = dict(_COMMON, kv_bits=kv_bits, device=CPU)
    plain = BatchedServer(cfg, model, **common)
    pr = {r.rid: r for r in plain.run(
        [Request(t.rid, np.array(t.prompt), t.max_new, priority=t.priority,
                 deadline_step=t.deadline_step, arrive_step=t.arrive_step)
         for t in trace.requests])}
    fe = ReplicaFrontend([BatchedServer(cfg, model, **common)])
    reqs, keys = requests_from_trace(trace)
    fe.run(reqs, keys)
    for r in reqs:
        p = pr[r.rid]
        assert list(r.out) == list(p.out), (kv_bits, r.rid, r.out, p.out)
        assert r.done == p.done and r.finish_step == p.finish_step
    assert fe.store is None            # inert at one replica
    assert _counters(fe.servers[0]) == _counters(plain)


# ---------------------------------------------------------------------------
# Routing, each decision against the reference's
# ---------------------------------------------------------------------------
def _req(cls, rid, arrive=0, n=4):
    rng = np.random.default_rng(100 + rid)
    return cls(rid, rng.integers(0, 50, n).astype(np.int32), 3,
               arrive_step=arrive)


def _both_frontends(models, **kw):
    jcfg, jparams, cfg, model = models
    return (jfe.ReplicaFrontend(jfe.make_replicas(2, jcfg, jparams,
                                                  **_COMMON), **kw),
            ReplicaFrontend(make_replicas(2, cfg, model, device=CPU,
                                          **_COMMON), **kw))


def test_route_sticky_affinity_and_rebalance(models):
    decisions = []
    for fe, cls in zip(_both_frontends(models, rebalance_margin=2.0),
                       (JRequest, Request)):
        key = ("chat", 0)
        first = fe.route(_req(cls, 0), key)
        assert fe.affinity[key] == first
        # sticky while the favored replica stays within the margin
        assert fe.route(_req(cls, 1), key) == first
        assert fe.metrics.counter("frontend.affinity_hits").value == 1
        # past the margin the affinity yields and the key is re-pinned
        scores = []
        for i in range(4):
            fe.loops[first].add(_req(cls, 10 + i))
            scores.append([fe.load_score(j) for j in (0, 1)])
        moved = fe.route(_req(cls, 2), key)
        assert moved != first and fe.affinity[key] == moved
        assert fe.metrics.counter("frontend.rebalanced").value == 1
        decisions.append((first, moved, scores,
                          fe.metrics.snapshot()["counters"]))
    assert decisions[0] == decisions[1]


def test_route_keyless_prefers_least_loaded(models):
    got = []
    for fe, cls in zip(_both_frontends(models), (JRequest, Request)):
        fe.loops[0].add(_req(cls, 0))
        fe.loops[0].add(_req(cls, 1))
        assert fe.route(_req(cls, 2), None) == 1
        assert not fe.affinity          # key-less traffic never pins
        got.append([fe.load_score(i) for i in (0, 1)])
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# Shared prefix store
# ---------------------------------------------------------------------------
def test_shared_prefix_store_roundtrip(models, traces):
    jcfg, jparams, cfg, model = models
    jtrace, trace = traces
    counts = []
    for mk, gen, kw in ((jfe.make_replicas, jtrace, {}),
                        (make_replicas, trace, dict(device=CPU))):
        a, b = mk(2, *((jcfg, jparams) if mk is jfe.make_replicas
                       else (cfg, model)), **_COMMON, kv_bits=8, **kw)
        reqs, _ = (jfe.requests_from_trace if mk is jfe.make_replicas
                   else requests_from_trace)(gen)
        a.run(reqs)
        chains_a = sum(1 for _ in a.prefix_cache.iter_chain_nodes())
        assert chains_a > 0, "trace produced no cached prefix chains"
        store = (jfe.SharedPrefixStore() if mk is jfe.make_replicas
                 else SharedPrefixStore())
        assert store.publish(a) == chains_a and len(store) == chains_a
        assert store.publish(a) == 0        # idempotent
        installed = store.install(b)
        assert installed > 0
        chains_b = {tuple(t) for _, t, _ in b.prefix_cache.iter_chain_nodes()}
        assert chains_b == {tuple(t) for _, t, _
                            in a.prefix_cache.iter_chain_nodes()}
        assert store.install(b) == 0        # already cached: no churn
        counts.append((chains_a, installed, sorted(chains_b)))
        if mk is make_replicas:
            # the installed host pages are the published bytes, copied
            ns = next(iter(store._chains.values()))
            for key, tokens, node in b.prefix_cache.iter_chain_nodes():
                want = ns[(key, tuple(tokens))]
                got = b.host_store.get(node.host)
                for rg, rw in zip(got.arrays, want.arrays):
                    for f in rw:
                        np.testing.assert_array_equal(rg[f], rw[f])
    assert counts[0] == counts[1]


def test_shared_store_namespaces_by_geometry(models):
    _, _, cfg, model = models
    a = make_replicas(1, cfg, model, device=CPU, **_COMMON, kv_bits=8)[0]
    b = make_replicas(1, cfg, model, device=CPU, **_COMMON, kv_bits=4)[0]
    c = make_replicas(1, cfg, model, device=CPU, **_COMMON, kv_bits=8)[0]
    a.run([_req(Request, 0, n=9)])
    store = SharedPrefixStore()
    assert store.publish(a) >= 1
    # the int4 pool's geometry differs: nothing may cross the namespace
    assert store.install(b) == 0
    assert store.install(c) == store.published


# ---------------------------------------------------------------------------
# Accounting and construction
# ---------------------------------------------------------------------------
def test_aggregate_goodput_accounting():
    def records(cls):
        def done(rid, finish, deadline=None):
            r = cls(rid, np.array([1, 2]), 1, deadline_step=deadline)
            r.done, r.finish_step = True, finish
            return r
        errored = done(4, finish=2)
        errored.error = "rejected"
        return [done(0, finish=3, deadline=5), done(1, finish=7),
                done(2, finish=9, deadline=5), cls(3, np.array([1]), 1),
                errored]
    assert aggregate_goodput(records(Request)) == pytest.approx(2 / 5)
    assert aggregate_goodput(records(Request)) == \
        jfe.aggregate_goodput(records(JRequest))
    assert aggregate_goodput([]) is None


def test_make_replicas_namespaced_registries(models):
    jcfg, jparams, cfg, model = models
    servers = make_replicas(2, cfg, model, device=CPU, **_COMMON)
    jservers = jfe.make_replicas(2, jcfg, jparams, **_COMMON)
    for i, (srv, jsrv) in enumerate(zip(servers, jservers)):
        gauges = srv.metrics.snapshot()["gauges"]
        assert gauges and all(k.startswith(f"replica{i}.") for k in gauges)
        assert set(gauges) == set(jsrv.metrics.snapshot()["gauges"])
        assert srv.model is model          # the weights are not copied
    fe = ReplicaFrontend(servers)
    fe.metrics.counter("frontend.routed").inc()
    snap = merged_snapshot(fe)
    assert "frontend.routed" in snap["counters"]
    assert any(k.startswith("replica0.") for k in snap["gauges"])
    assert any(k.startswith("replica1.") for k in snap["gauges"])
    with pytest.raises(ValueError) as port:
        make_replicas(2, cfg, model, registry=object())
    with pytest.raises(ValueError) as ref:
        jfe.make_replicas(2, jcfg, jparams, registry=object())
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError):
        make_replicas(0, cfg, model)
    with pytest.raises(ValueError):
        ReplicaFrontend([])


# ---------------------------------------------------------------------------
# Two replicas end to end, and the replica A/B bench
# ---------------------------------------------------------------------------
def test_two_replica_counters_equal_the_reference(models, traces):
    jcfg, jparams, cfg, model = models
    jtrace, trace = traces
    jfront = jfe.ReplicaFrontend(jfe.make_replicas(2, jcfg, jparams,
                                                   **_COMMON, kv_bits=8))
    jreqs, jkeys = jfe.requests_from_trace(jtrace)
    jfront.run(jreqs, jkeys)
    fe = ReplicaFrontend(make_replicas(2, cfg, model, device=CPU,
                                       **_COMMON, kv_bits=8))
    reqs, keys = requests_from_trace(trace)
    assert keys == jkeys
    fe.run(reqs, keys)
    got, want = _counters(fe), _counters(jfront)
    assert got == want
    assert got["frontend.shared_prefix_pages"] >= 1
    assert got["frontend.routed_replica0"] and got["frontend.routed_replica1"]
    assert [(r.done, r.finish_step) for r in reqs] == \
        [(r.done, r.finish_step) for r in jreqs]
    assert aggregate_goodput(reqs) == jfe.aggregate_goodput(jreqs)
    gate = accuracy_gate([list(r.out) for r in jreqs],
                         [list(r.out) for r in reqs], **GATE)
    assert gate["passed"], gate


def _port_only(res: dict) -> dict:
    for arm in ("one_replica", "two_replica"):
        res[arm] = {k: v for k, v in res[arm].items()
                    if k not in ("counters", "gen_tokens")}
    return res


def test_run_replicas_fields_equal_the_reference(models, tmp_path):
    _, _, cfg, model = models
    with scratch_results(tmp_path):
        want = jtraffic.run_replicas(fast=True, verbose=False)
        got = ttraffic.run_replicas(cfg, model, fast=True, verbose=False)
    assert _port_only(comparable(got, "replicas")) == \
        comparable(want, "replicas")
    assert got["two_replica"]["goodput"] > got["one_replica"]["goodput"]
    c2 = got["two_replica"]["counters"]
    assert sum(c2[f"frontend.routed_replica{i}"] for i in (0, 1)) \
        == got["trace"]["requests"]
