"""Port parity, ``benchmarks/traffic.py --mode serve`` at ``--fast`` on the
CPU: the bursty overload trace through the SLO scheduler with the async host
pager, predictor off and on, against an ample-pool reference server. Both
packages' telemetry read a fake clock (the predictor's TPOT feature reads
the wall clock), so every field that is not a time or a token agreement is
equal: the trace's fingerprint and overload, both arms' goodput and deadline
misses, the predictor's gated admissions and updates, the pager's demotions
and promotions. (Each package's page store reads the same fake clock as its
tracer: the pager's spans are stamped there, and the overlap gate compares
them with the decode spans.) Both packages' gates pass, their tokens agree
per ``accuracy_gate``, the overload gate made to fail raises the reference's
words, and the replica A/B runs (``--mode replicas``)."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_bench import (GATE, FakeClock, comparable,  # noqa: E402
                          flat_tokens, reference_model, scratch_results)

from benchmarks import traffic as jtraffic  # noqa: E402
from repro.core import page_store as jstore  # noqa: E402
from repro.runtime import telemetry as jtel  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.core import page_store as tstore  # noqa: E402
from repro_torch.benchmarks import traffic as ttraffic  # noqa: E402
from repro_torch.benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro_torch.launch.serve import Request  # noqa: E402
from repro_torch.runtime import telemetry as ttel  # noqa: E402


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traffic")
    cfg, model = reference_model()
    with scratch_results(tmp) as (jlog, tlog), \
            pytest.MonkeyPatch.context() as mp:
        for tel, store in ((jtel, jstore), (ttel, tstore)):
            clock = FakeClock()
            mp.setattr(tel, "time", clock)
            mp.setattr(store, "time", clock)
        want = jtraffic.run_serve(fast=True, verbose=False)
        got = ttraffic.run_serve(cfg, model, fast=True, verbose=False)
    return got, want, tlog, jlog, tmp


def test_fields_equal_the_reference(runs):
    got, want, _, _, _ = runs
    assert comparable(got, "traffic") == comparable(want, "traffic")
    assert got["predictor_on"]["predictor_gated"] >= 1
    assert got["predictor_on"]["pager_demotions"] >= 1


def test_tokens_agree_with_the_reference(runs):
    _, _, tlog, jlog, _ = runs
    assert [len(r) for r in tlog] == [len(r) for r in jlog] and len(tlog) == 3
    gate = accuracy_gate(flat_tokens(jlog), flat_tokens(tlog), **GATE)
    assert gate["passed"], gate


def test_gates_and_artifacts(runs):
    got, _, _, _, tmp = runs
    assert got["trace"]["overload_ratio"] >= 1.5
    assert got["predictor_on"]["goodput"] > got["predictor_off"]["goodput"]
    assert got["goodput_delta"] > 0
    for arm in ("predictor_off", "predictor_on"):
        assert got[arm]["token_agreement"] >= 0.9
    events = json.loads(
        (tmp / "port" / "torch_trace_traffic.json").read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    assert ttraffic._pager_overlaps_decode(events)
    assert jtraffic._pager_overlaps_decode(events)
    lines = (tmp / "port" / "torch_metrics_traffic.jsonl").read_text()
    snaps = [json.loads(x) for x in lines.splitlines()]
    assert snaps and all("counters" in s for s in snaps)
    assert set(got["slo_gauges_on"]) == {
        k for k in snaps[-1]["gauges"] if k.startswith("slo.")}
    traj = json.loads((tmp / "port" / "torch_BENCH_serve.json").read_text())
    assert traj["trajectory"][-1]["summary"]["traffic"]["goodput"] == \
        got["predictor_on"]["goodput"]


def test_pager_overlap_needs_an_async_span_inside_a_decode_span():
    def x(name, ts, dur, tid=0, **args):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": args}
    dec = x("decode_span", 10, 10)
    for events in ([dec, x("pager.demote", 15, 2, ttel.PAGER_TID,
                           async_=True)],
                   [dec, x("pager.demote", 15, 2, ttel.PAGER_TID)],
                   [dec, x("pager.demote", 20, 2, ttel.PAGER_TID,
                           **{"async": True})],
                   [dec, x("pager.offload", 5, 6, ttel.PAGER_TID,
                           **{"async": True})]):
        assert (ttraffic._pager_overlaps_decode(events)
                == jtraffic._pager_overlaps_decode(events))
    assert ttraffic._pager_overlaps_decode(
        [dec, x("pager.offload", 5, 6, ttel.PAGER_TID, **{"async": True})])


def test_token_agreement_matches_reference():
    rng = np.random.default_rng(0)
    ref = {i: Request(i, np.zeros(1, np.int32), 3) for i in range(5)}
    outs = [[], [1, 2], [1, 2, 3], [4], []]
    for r, o in zip(ref.values(), [[], [1, 3], [1, 2, 3], [], [7]]):
        r.out = o
    reqs = []
    for i, o in enumerate(outs):
        r = Request(i, np.zeros(1, np.int32), 3)
        r.out = o
        reqs.append(r)
    assert (ttraffic._token_agreement(reqs, ref)
            == jtraffic._token_agreement(reqs, ref) == 0.5)
    for r in reqs:
        r.out = list(rng.integers(0, 3, 3))
    assert (ttraffic._token_agreement(reqs, ref)
            == jtraffic._token_agreement(reqs, ref))


def test_overload_gate_raises_the_reference_words(tmp_path, monkeypatch):
    """A calm trace (one slow Poisson tenant) in both packages: the
    overload gate fails before any serving, with the same message."""
    cfg, model = reference_model()
    errors = []
    with scratch_results(tmp_path):
        for mod, call in (
                (jtraffic, lambda: jtraffic.run_serve(fast=True,
                                                      verbose=False)),
                (ttraffic, lambda: ttraffic.run_serve(cfg, model, fast=True,
                                                      verbose=False))):
            base = mod.overload_trace_config

            def calm(vocab, fast=False, base=base):
                import dataclasses
                c = base(vocab, fast=fast)
                return dataclasses.replace(c, process="poisson", rate=0.05,
                                           tenants=c.tenants[1:])
            monkeypatch.setattr(mod, "overload_trace_config", calm)
            with pytest.raises(RuntimeError) as e:
                call()
            errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("traffic trace is not an overload")


def test_replicas_are_refused_with_their_item(tmp_path, monkeypatch):
    """The replica A/B is ported: ``--mode replicas`` runs on the CPU and
    passes the reference's three gates (the 1-replica frontend is the
    plain server, both arms agree with the ample-pool reference, 2
    replicas buy goodput); ``tests/test_torch_replicas.py`` holds its
    fields against the reference's."""
    monkeypatch.setattr(tcommon, "RESULTS", tmp_path)
    res = ttraffic.main(["--mode", "replicas", "--fast", "--device", "cpu"])
    rep = res["replicas"]
    assert rep["two_replica"]["goodput"] > rep["one_replica"]["goodput"]
    assert min(rep["one_replica"]["token_agreement"],
               rep["two_replica"]["token_agreement"]) >= 0.9
    assert (tmp_path / "torch_traffic_replicas.json").exists()


def test_modes(tmp_path, monkeypatch):
    monkeypatch.setattr(tcommon, "RESULTS", tmp_path)
    res = ttraffic.main(["--mode", "accounting"])
    assert set(res) == {"accounting"}
    assert (tmp_path / "torch_traffic.json").exists()
    with pytest.raises(ValueError, match="unknown mode"):
        ttraffic.run(mode="bogus")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttraffic.main(["--mode", "serve", "--fast"])
