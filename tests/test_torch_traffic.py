"""Port parity, the traffic harness (``tests/test_traffic.py`` on the
port): ``generate_trace`` keeps the reference's draw order, so
``trace_fingerprint`` is equal across packages for several configs (and
the serving harness's overload trace and its requests are the
reference's); generator validation; the deadline-miss predictor's risk,
peak-held hazard, budget bands and SGD equal the reference's step for
step; ``extract_page_async`` resolves to the reference's page bytes on the
CPU; serving with ``predictor="off"`` and either pager mode is
token-identical to a server built without the new options, and the flags
validate as the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, torch_model  # noqa: E402

from benchmarks import traffic as jbench  # noqa: E402
from repro.core import page_store as jps  # noqa: E402
from repro.core import traffic as jtraffic  # noqa: E402
from repro.launch.scheduler import \
    DeadlineMissPredictor as JPredictor  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.runtime.telemetry import MetricsRegistry as JRegistry  # noqa: E402
from repro_torch.benchmarks import traffic as tbench  # noqa: E402
from repro_torch.core import page_store as tps  # noqa: E402
from repro_torch.core import traffic as ttraffic  # noqa: E402
from repro_torch.launch.scheduler import DeadlineMissPredictor  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.runtime.telemetry import MetricsRegistry  # noqa: E402

CPU = torch.device("cpu")


def _mix(mod, seed=11, **kw):
    cfg = dict(seed=seed, horizon=48, rate=0.3, process="bursty",
               burst_rate=1.8, p_enter_burst=0.15, p_exit_burst=0.3,
               vocab_size=997,
               tenants=(
                   mod.TenantSpec("chat", weight=0.7, priority=5,
                                  deadline_slack=4, prompt_mean=8.0,
                                  prompt_cap=16, max_new_mean=4.0,
                                  max_new_cap=6, shared_prefix_len=6,
                                  prefix_pool=3),
                   mod.TenantSpec("batch", weight=0.3, priority=0,
                                  deadline_slack=None, prompt_mean=12.0,
                                  prompt_cap=24, max_new_mean=10.0,
                                  max_new_cap=16)))
    cfg.update(kw)
    return mod.TraceConfig(**cfg)


_CONFIGS = {
    "bursty-mix": {},
    "poisson": dict(process="poisson", seed=3, horizon=64),
    "big-vocab": dict(vocab_size=152064, seed=7, horizon=96),
    "one-tenant": dict(tenants="default"),
}


def _config(mod, name):
    kw = dict(_CONFIGS[name])
    if kw.get("tenants") == "default":
        kw["tenants"] = (mod.TenantSpec("default", shared_prefix_len=5,
                                        prefix_pool=4, zipf_a=1.1),)
    return _mix(mod, **kw)


# ---------------------------------------------------------------------------
# trace generation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(_CONFIGS))
def test_trace_fingerprint_equals_reference(name):
    port = ttraffic.generate_trace(_config(ttraffic, name))
    ref = jtraffic.generate_trace(_config(jtraffic, name))
    assert ttraffic.trace_fingerprint(port) == \
        jtraffic.trace_fingerprint(ref)
    assert len(port.requests) == len(ref.requests) > 0
    assert port.burst_steps == ref.burst_steps
    assert port.offered_rate == ref.offered_rate
    assert port.burst_rate_observed() == ref.burst_rate_observed()
    assert port.overload_ratio(4) == ref.overload_ratio(4)
    for a, b in zip(port.requests, ref.requests):
        assert (a.rid, a.tenant, a.arrive_step, a.max_new, a.priority,
                a.deadline_step, a.prefix_id) == \
            (b.rid, b.tenant, b.arrive_step, b.max_new, b.priority,
             b.deadline_step, b.prefix_id)
        assert a.prompt.dtype == np.int32
        np.testing.assert_array_equal(a.prompt, b.prompt)


def test_trace_structural_invariants():
    tr = ttraffic.generate_trace(_mix(ttraffic))
    cfg = tr.config
    tenants = {t.name: t for t in cfg.tenants}
    prefixes = {}
    for r in tr.requests:
        t = tenants[r.tenant]
        assert 0 <= r.arrive_step < cfg.horizon
        assert 1 <= r.max_new <= t.max_new_cap
        assert np.all((r.prompt >= 0) & (r.prompt < cfg.vocab_size))
        if t.deadline_slack is None:
            assert r.deadline_step is None
        else:
            assert r.deadline_step == \
                r.arrive_step + r.max_new + t.deadline_slack
        if t.shared_prefix_len > 0:
            key = (r.tenant, r.prefix_id)
            head = r.prompt[:t.shared_prefix_len]
            if key in prefixes:
                np.testing.assert_array_equal(head, prefixes[key])
            prefixes[key] = head
        else:
            assert r.prefix_id == -1
    assert tr.overload_ratio(batch_size=2) > 1.0 and tr.burst_steps
    assert ttraffic.trace_fingerprint(tr) != ttraffic.trace_fingerprint(
        ttraffic.generate_trace(_mix(ttraffic, seed=12)))


def test_trace_generator_validation():
    with pytest.raises(ValueError, match="process"):
        ttraffic.generate_trace(ttraffic.TraceConfig(process="fractal"))
    with pytest.raises(ValueError, match="tenant"):
        ttraffic.generate_trace(ttraffic.TraceConfig(tenants=()))
    with pytest.raises(ValueError, match="weights"):
        ttraffic.generate_trace(ttraffic.TraceConfig(
            tenants=(ttraffic.TenantSpec("a", weight=0.0),)))


@pytest.mark.parametrize("fast", [True, False])
def test_overload_trace_and_requests_equal_reference(fast):
    port = ttraffic.generate_trace(tbench.overload_trace_config(256,
                                                                fast=fast))
    ref = jtraffic.generate_trace(jbench.overload_trace_config(256,
                                                               fast=fast))
    assert ttraffic.trace_fingerprint(port) == \
        jtraffic.trace_fingerprint(ref)
    for a, b in zip(tbench.to_requests(port), jbench.to_requests(ref)):
        assert isinstance(a, Request)
        assert (a.rid, a.max_new, a.priority, a.deadline_step,
                a.arrive_step) == (b.rid, b.max_new, b.priority,
                                   b.deadline_step, b.arrive_step)
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert a.prompt is not port.requests[a.rid].prompt


# ---------------------------------------------------------------------------
# the deadline-miss predictor, step for step against the reference's
# ---------------------------------------------------------------------------
def _feat(pred, **kw):
    base = dict(queue_deadlined=0, batch=4, free_frac=1.0, prefill_debt=0,
                debt_cap=32, live_frac=0.0, arrival_ewma=0.0,
                tpot_slowdown=0.0)
    base.update(kw)
    return pred.features(**base)


_PRESSURES = [dict(queue_deadlined=8), dict(arrival_ewma=2.0),
              dict(free_frac=0.0), dict(prefill_debt=32),
              dict(live_frac=1.0), dict(tpot_slowdown=0.25),
              dict(queue_deadlined=8, arrival_ewma=2.0, free_frac=0.0,
                   prefill_debt=32, live_frac=1.0),
              dict(queue_deadlined=10 ** 6, arrival_ewma=10 ** 6,
                   prefill_debt=10 ** 6, live_frac=50.0, tpot_slowdown=9.0)]


def test_predictor_risk_matches_reference():
    p, j = DeadlineMissPredictor(MetricsRegistry()), JPredictor(JRegistry())
    calm = p.risk(_feat(p))
    assert calm == j.risk(_feat(j)) and 0.0 < calm < p.gate_at
    for kw in _PRESSURES:
        x = _feat(p, **kw)
        assert x == _feat(j, **kw)
        assert p.risk(x) == j.risk(x) > calm, kw
        assert all(-0.25 <= xi <= 1.0 for xi in x)
    assert p.risk(_feat(p, **_PRESSURES[6])) > p.gate_at


def test_predictor_hazard_and_budget_bands_match_reference():
    p, j = DeadlineMissPredictor(MetricsRegistry()), JPredictor(JRegistry())
    rng = np.random.default_rng(5)
    for step in range(300):
        kw = _PRESSURES[6] if step % 37 == 0 else dict(
            queue_deadlined=int(rng.integers(0, 6)),
            free_frac=float(rng.uniform()))
        assert p.consult(_feat(p, **kw)) == j.consult(_feat(j, **kw))
        assert p.hazard == j.hazard
        assert p.spec_budget(4) == j.spec_budget(4)
    assert p.metrics.gauge("sched.miss_hazard").value == p.hazard
    for h, want in ((p.gate_at - 0.01, 4),
                    ((p.gate_at + (1.0 + p.gate_at) / 2.0) / 2.0, 1),
                    (0.99, 0)):
        p.hazard = j.hazard = h
        assert p.spec_budget(4) == j.spec_budget(4) == want


def test_predictor_sgd_matches_reference():
    p, j = DeadlineMissPredictor(MetricsRegistry()), JPredictor(JRegistry())
    x = _feat(p, queue_deadlined=4, arrival_ewma=1.0, free_frac=0.4)
    risks = [p.risk(x)]
    for missed in (True, False):
        for _ in range(50):
            p.observe(x, missed)
            j.observe(x, missed)
            assert p.w == j.w
        risks.append(p.risk(x))
    assert risks[1] > risks[0] and risks[2] < risks[1]
    assert p.updates == 100 and p.metrics.value(
        "sched.predictor_updates") == 100


# ---------------------------------------------------------------------------
# async extraction on the CPU
# ---------------------------------------------------------------------------
def test_extract_page_async_matches_reference_bytes():
    import jax.numpy as jnp
    from repro_torch.core import paged_kv as tpk
    rng = np.random.default_rng(1)
    pool = {"k_pages": torch.from_numpy(rng.integers(-127, 128, (6, 4, 2, 16))
                                        .astype(np.int8)),
            "v_pages": torch.from_numpy(rng.integers(-127, 128, (6, 4, 2, 16))
                                        .astype(np.int8)),
            "k_scale": torch.from_numpy(rng.uniform(0.1, 1, 6)
                                        .astype(np.float32)),
            "v_scale": torch.from_numpy(rng.uniform(0.1, 1, 6)
                                        .astype(np.float32))}
    ref = [({k: jnp.asarray(np.stack([v.numpy()])) for k, v in
             pool.items()},)]
    caches = [pool]
    pending = tps.extract_page_async(caches, 2)
    tps.inject_page(caches, tps.extract_page(caches, 1), 2)
    blob = pending.resolve()
    want = jps.extract_page(ref, 2)
    for a, b in zip(blob.arrays, want.arrays):
        for f in a:
            assert a[f].tobytes() == np.asarray(b[f]).tobytes()
    assert tpk.caches_kv_bytes(caches)["int8"] > 0


# ---------------------------------------------------------------------------
# predictor off and the pager modes are token-neutral; flags validate
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=2)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def _neutral_trace(vocab):
    rng = np.random.default_rng(13)
    sys_p = rng.integers(0, vocab, 6).astype(np.int32)
    reqs = []
    for i, L in enumerate([3, 9, 5, 12, 2, 7]):
        p = np.concatenate([sys_p, rng.integers(0, vocab, L)
                            .astype(np.int32)])
        reqs.append(Request(i, p, 4 + (i % 3), priority=i % 2,
                            deadline_step=(None if i % 2 else 30 + 4 * i),
                            arrive_step=2 * i))
    return reqs


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_predictor_off_is_token_neutral(models, kv_bits):
    _, tcfg, _, model = models
    base = dict(batch_size=2, max_len=48, kv_bits=kv_bits, page_size=8,
                prefill="bucketed", prefill_bucket=8, prefix_cache="on",
                kv_offload="host", sched="slo", preempt=False, device=CPU)
    seed = BatchedServer(tcfg, model, **base).run(
        _neutral_trace(tcfg.vocab_size))
    off = BatchedServer(tcfg, model, metrics="on", predictor="off",
                        pager_async="off", **base)
    asy = BatchedServer(tcfg, model, metrics="on", predictor="off",
                        pager_async="on", **base)
    out_off = off.run(_neutral_trace(tcfg.vocab_size))
    out_asy = asy.run(_neutral_trace(tcfg.vocab_size))
    for a, b, c in zip(seed, out_off, out_asy):
        assert a.out == b.out == c.out, (kv_bits, a.rid)
    assert off.predictor is None and asy.predictor is None
    assert asy.pager.async_mode and not off.pager.async_mode
    assert off.tracer.slo_summary()["requests"] == len(out_off)


@pytest.mark.parametrize("kw", [dict(predictor="on"),
                                dict(pager_async="on"),
                                dict(sched="slo", predictor="maybe"),
                                dict(sched="slo", pager_async="maybe")])
def test_predictor_and_pager_flag_validation(models, kw):
    jcfg, tcfg, jparams, model = models
    base = dict(batch_size=2, max_len=32, page_size=8)
    with pytest.raises(ValueError) as ref:
        JServer(jcfg, jparams, **base, **kw)
    with pytest.raises(ValueError) as port:
        BatchedServer(tcfg, model, device=CPU, **base, **kw)
    assert str(port.value) == str(ref.value)
