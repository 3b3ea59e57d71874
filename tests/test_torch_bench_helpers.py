"""Port parity, the serving benches' helpers: the metrics registry's
warm-up boundary (``reset``, ``checkpoint``, ``since``) against the
reference's registry driven the same way, ``decode_agreement`` and
``accuracy_gate`` against the reference's on drawn token streams, the
teacher-forcing taps on a served run on the CPU, the port's serving
trajectory file and results directory, and the benches' host counters
read by name."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from _compat import given, settings, strategies as st  # noqa: E402

from benchmarks import lm_precision as jlm  # noqa: E402
from repro.runtime import telemetry as jtel  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.benchmarks import lm_precision as tlm  # noqa: E402
from repro_torch.benchmarks import paged_serve as tps  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.runtime import telemetry as ttel  # noqa: E402

CPU = torch.device("cpu")


def _drive(tel):
    """One script of registry events in either package's telemetry;
    returns what each boundary call read."""
    class Srv:
        steps = tel.metric_attr("serve.decode_steps")

        def __init__(self):
            self.metrics = tel.MetricsRegistry()

    srv = Srv()
    reg = srv.metrics
    held = reg.counter("serve.prefill_forwards")
    hist = reg.histogram("pager.demote_s")
    reg.register_gauge("kv.device_pages_free", lambda: 7)
    reg.gauge("slo.window_goodput").set(0.5)
    srv.steps = 3
    held.inc(2)
    hist.observe(0.25)
    mark = reg.checkpoint()
    srv.steps += 4
    held.inc(0.5)
    reg.counter("sched.defers").inc()
    hist.observe(1.0)
    since = reg.since(mark)
    before = reg.snapshot()
    reg.reset()
    after = reg.snapshot()
    # the held object and the descriptor still write the registry
    held.inc()
    srv.steps += 2
    return {"mark": mark, "since": since, "before": before, "after": after,
            "again": reg.snapshot(), "steps": srv.steps,
            "held_is_registered": held is reg.counter(
                "serve.prefill_forwards")}


def test_registry_warmup_boundary_matches_reference():
    got, want = _drive(ttel), _drive(jtel)
    assert got == want
    assert got["since"]["serve.decode_steps"] == 4
    assert got["since"]["serve.prefill_forwards"] == 0.5
    assert got["held_is_registered"] and got["steps"] == 2


def test_registry_reset_zeroes_counters_and_histograms_not_gauges():
    got = _drive(ttel)
    assert set(got["after"]["counters"].values()) == {0}
    assert all(h == {"count": 0} for h in got["after"]["histograms"].values())
    assert got["after"]["gauges"] == got["before"]["gauges"] == {
        "kv.device_pages_free": 7, "slo.window_goodput": 0.5}
    assert got["again"]["counters"]["serve.prefill_forwards"] == 1


def test_registry_since_an_empty_checkpoint_is_every_counter():
    for tel in (ttel, jtel):
        reg = tel.MetricsRegistry()
        reg.counter("a").inc(3)
        assert reg.since({}) == {"a": 3}
        assert reg.checkpoint() == {"a": 3}
    c = ttel.Counter("x")
    c.inc(5)
    c.reset()
    assert c.value == 0
    h = ttel.Histogram("y")
    h.observe(2.0)
    h.reset()
    assert h.count == 0 and h.percentile(50) is None


_streams = st.lists(
    st.tuples(st.lists(st.integers(0, 3), min_size=0, max_size=6),
              st.lists(st.integers(0, 3), min_size=0, max_size=6)),
    min_size=1, max_size=8)


@settings(max_examples=60, deadline=None)
@given(_streams, st.floats(0.0, 1.0), st.floats(0.0, 1.0),
       st.floats(0.0, 0.5))
def test_accuracy_gate_matches_reference(pairs, min_agreement,
                                         request_floor, allowed):
    ref = [p[0] for p in pairs]
    test = [p[1] for p in pairs]
    kw = dict(min_agreement=min_agreement, request_floor=request_floor,
              allowed_below_floor=allowed)
    assert tlm.accuracy_gate(ref, test, **kw) == jlm.accuracy_gate(
        ref, test, **kw)
    assert tlm.accuracy_gate(ref, test) == jlm.accuracy_gate(ref, test)
    assert tlm.decode_agreement(ref, test) == jlm.decode_agreement(ref, test)


def test_accuracy_gate_counts_violations():
    ref = [[1, 2, 3, 4]] * 4
    garbled = [[1, 2, 3, 4]] * 3 + [[0, 0, 0, 0]]
    g = tlm.accuracy_gate(ref, garbled, min_agreement=0.7)
    assert g["below_floor"] == 1 and g["violations"] == 1 and not g["passed"]
    g = tlm.accuracy_gate(ref, garbled, min_agreement=0.7,
                          allowed_below_floor=0.25)
    assert g["passed"] and g["agreement"] == 0.75


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config("qwen2-72b")
    return cfg, init_model(cfg, seed=0, device=CPU)


def _requests(vocab):
    rng = np.random.default_rng(1)
    return [Request(i, rng.integers(0, vocab, 3 + 2 * i).astype(np.int32),
                    6) for i in range(5)]


@pytest.mark.parametrize("fused", ["off", "on"])
def test_teacher_force_feeds_the_given_tokens(smoke, fused):
    """Forced by its own tokens a run repeats itself; forced by another
    stream, request rid's step g sees that stream's token g - 1, so its
    outputs are what a run of those inputs gives, not its own."""
    cfg, model = smoke
    kw = dict(batch_size=2, max_len=32, page_size=8, kv_bits=8,
              prefill="bucketed", fused=fused, device=CPU)
    free = BatchedServer(cfg, model, **kw).run(_requests(cfg.vocab_size))
    srv = BatchedServer(cfg, model, **kw)
    tap = tlm.teacher_force(srv, {r.rid: list(r.out) for r in free})
    assert isinstance(tap, tlm.FusedTap if fused == "on" else tlm.DecodeTap)
    same = srv.run(_requests(cfg.vocab_size))
    assert [r.out for r in same] == [r.out for r in free]
    assert tap.logits == {}                  # record=False keeps none
    other = {r.rid: [(t + 1) % cfg.vocab_size for t in r.out] for r in free}
    srv = BatchedServer(cfg, model, **kw)
    tlm.teacher_force(srv, other)
    forced = srv.run(_requests(cfg.vocab_size))
    assert [r.out[0] for r in forced] == [r.out[0] for r in free]
    assert [r.out for r in forced] != [r.out for r in free]


def test_decode_tap_records_logits(smoke):
    cfg, model = smoke
    srv = BatchedServer(cfg, model, batch_size=2, max_len=32, page_size=8,
                        kv_bits=8, device=CPU)
    srv.decode = tap = tlm.DecodeTap(srv)
    reqs = srv.run(_requests(cfg.vocab_size))
    for r in reqs:
        for g in range(len(r.out)):
            assert int(tap.logits[(r.rid, g)].argmax()) == r.out[g]


def test_trajectory_appends_points(tmp_path, monkeypatch):
    monkeypatch.setattr(tcommon, "RESULTS", tmp_path)
    path = tcommon.trajectory_path()
    assert path == tmp_path / "torch_BENCH_serve.json"
    tcommon.append_trajectory({"summary": {"a": 1}})
    tcommon.append_trajectory({"summary": {"a": 2}})
    traj = json.loads(path.read_text())
    assert traj["bench"] == "paged_serve"
    assert [p["summary"]["a"] for p in traj["trajectory"]] == [1, 2]
    path.write_text("{not json")
    tcommon.append_trajectory({"summary": {"a": 3}})
    assert len(json.loads(path.read_text())["trajectory"]) == 1


def test_results_in_restores_the_directory(tmp_path):
    before = tcommon.RESULTS
    with tcommon.results_in(tmp_path / "a") as d:
        assert tcommon.RESULTS == d == tmp_path / "a"
        assert tcommon.save_json("x.json", {}) == d / "torch_x.json"
        assert tcommon.trajectory_path() == d / "torch_BENCH_serve.json"
    assert tcommon.RESULTS == before
    with pytest.raises(ValueError):
        with tcommon.results_in(tmp_path / "b"):
            raise ValueError
    assert tcommon.RESULTS == before


def _nest(paths):
    res = {}
    for i, path in enumerate(paths):
        *outer, last = path.split(".")
        node = res
        for k in outer:
            node = node.setdefault(k, {})
        node[last] = i
    return res


@pytest.mark.parametrize("workload", sorted(tps.HOST_COUNTERS))
def test_host_counters_are_read_by_name(workload):
    """Every listed counter is read from its path (and each mixed row's by
    the row's name); one that is missing raises instead of dropping out
    of a comparison; ``wall_clock=False`` leaves out only the
    predictor-on arm."""
    paths = tps.HOST_COUNTERS[workload]
    res = _nest(paths)
    if workload == "mixed":
        res["rows"] = [dict(name=n, **{k: k for k in tps.ROW_COUNTERS},
                            tokens_per_s=1.0) for n in ("a", "b")]
    got = tps.host_counters(workload, res)
    assert {p: got[p] for p in paths} == {p: i for i, p in enumerate(paths)}
    rows = {k for k in got if k.startswith("rows.")}
    assert rows == ({f"rows.{n}.{k}" for n in "ab" for k in tps.ROW_COUNTERS}
                    if workload == "mixed" else set())
    steady = tps.host_counters(workload, res, wall_clock=False)
    assert set(got) - set(steady) == {p for p in paths
                                      if p.startswith("predictor_on.")}
    *outer, last = paths[-1].split(".")
    node = res
    for k in outer:
        node = node[k]
    del node[last]
    with pytest.raises(KeyError):
        tps.host_counters(workload, res)
