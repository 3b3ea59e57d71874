"""Port parity, ``benchmarks/paged_serve.py``'s mixed and prefix
workloads at ``--fast`` on the CPU: the reference's bench with its own
weights (``init_model(PRNGKey(0))``) against the port's bench with the
same weights converted. Every field that is not a time, a rate or a
token agreement is equal (prefill forwards, KV bytes per token-slot,
cache MiB, token capacity, hit rates, CoW copies, at-rest bytes); both
packages' gates pass; their tokens agree per ``accuracy_gate``; a gate
made to fail raises the reference's words. Also ``report --serve`` on
the port's trajectory against the reference's section on the same
points, the trajectory's path, and the repository's ``BENCH_serve.json``
left byte for byte as it was."""
import hashlib
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_bench import (GATE, ROOT, comparable, flat_tokens,  # noqa: E402
                          reference_model, reference_params,
                          scratch_results)

from benchmarks import paged_serve as jps  # noqa: E402
from benchmarks import report as jreport  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.benchmarks import paged_serve as tps  # noqa: E402
from repro_torch.benchmarks import report as treport  # noqa: E402
from repro_torch.benchmarks.lm_precision import accuracy_gate  # noqa: E402


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both benches' mixed (with batched prefill) and prefix workloads,
    once; the repository's BENCH_serve.json digested before and after."""
    tmp = tmp_path_factory.mktemp("paged_serve")
    cfg, model = reference_model()
    before = _digest(ROOT / "BENCH_serve.json")
    out = {}
    for w in ("mixed", "prefix"):
        with scratch_results(tmp) as (jlog, tlog):
            want = jps.run(fast=True, workload=w, verbose=False)
            got = tps.run(cfg, model, fast=True, workload=w, verbose=False)
        out[w] = (got, want, tlog, jlog)
    out["digests"] = (before, _digest(ROOT / "BENCH_serve.json"))
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("workload", ["mixed", "prefix"])
def test_fields_equal_the_reference(runs, workload):
    got, want, _, _ = runs[workload]
    assert (comparable(got, workload)
            == comparable(want, workload, reference=True))


def test_mixed_rows(runs):
    got, _, _, _ = runs["mixed"]
    rows = {r["name"]: r for r in got["rows"]}
    assert list(rows) == ["dense-fp32", "paged-int8-step", "paged-int8",
                          "paged-int4", "paged-int8-kernel"]
    assert rows["paged-int8-kernel"]["attn_impl"] == "kernel"
    assert rows["paged-int8-step"]["prefill"] == "stepwise"
    # int8 about 4x and int4 about 8x below the float32 slab a token
    assert 3.5 < rows["paged-int8"]["footprint_reduction_vs_fp32"] < 4
    assert 7 < rows["paged-int4"]["footprint_reduction_vs_fp32"] < 8
    s = got["summary"]
    assert s["prefill_forwards_bucketed"] < s["prefill_forwards_stepwise"]
    bp = s["batched_prefill"]
    assert bp["prefill_forwards_batched"] < bp["prefill_forwards_sequential"]


@pytest.mark.parametrize("workload", ["mixed", "prefix"])
def test_tokens_agree_with_the_reference(runs, workload):
    _, _, tlog, jlog = runs[workload]
    assert [len(r) for r in tlog] == [len(r) for r in jlog]
    gate = accuracy_gate(flat_tokens(jlog), flat_tokens(tlog), **GATE)
    assert gate["passed"], gate


def test_prefix_gates_and_counts(runs):
    got, _, _, _ = runs["prefix"]
    assert got["prefill_forwards_on"] < got["prefill_forwards_off"]
    assert got["prefix_hit_rate"] > 0 and got["cow_copies"] > 0
    assert got["token_agreement_on_vs_off"] >= 0.9
    b = got["kv_at_rest_bytes"]
    assert b["uniform-int4"] < b["profile-int8/int4"] < b["uniform-int8"]


def test_results_and_trajectory_stay_out_of_the_repository(runs):
    tmp = runs["tmp"] / "port"
    assert {p.name for p in tmp.iterdir()} >= {
        "torch_paged_serve.json", "torch_prefix_serve.json",
        "torch_BENCH_serve.json"}
    traj = json.loads((tmp / "torch_BENCH_serve.json").read_text())
    assert [sorted(p["summary"])[:1] for p in traj["trajectory"]] == [
        ["batched_prefill"], ["prefix"]]
    before, after = runs["digests"]
    assert before == after


def test_report_serve_matches_the_reference_section(runs, monkeypatch):
    """The reference's section read from a copy of the port's trajectory
    is the port's, but for the file named in the title."""
    path = runs["tmp"] / "port" / "torch_BENCH_serve.json"
    monkeypatch.setattr(tcommon, "RESULTS", path.parent)
    monkeypatch.setattr(jreport, "BENCH_TRAJECTORY", str(path))
    got = treport.serve_section()
    want = jreport.serve_section()
    assert "### mixed (fast, 1 point)" in got
    assert "tokens_per_s[paged-int8-kernel]" in got
    assert got.replace("torch_BENCH_serve.json", "BENCH_serve.json") == want


def test_report_serve_without_a_trajectory(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tcommon, "RESULTS", tmp_path)
    treport.main(["--serve"])
    assert "no torch_BENCH_serve.json trajectory" in capsys.readouterr().out


def one_row_batching(cls):
    """``cls`` with every server's prefill batch cut to one row."""
    def make(*a, **kw):
        return cls(*a, **dict(kw, prefill_batch=1))
    return make


def test_batched_prefill_gate_raises_the_reference_words(tmp_path,
                                                         monkeypatch):
    """Both packages' batched arm forced to one row a forward: the
    forward-count gate fails with the same message."""
    jcfg, jparams = reference_params()
    cfg, model = reference_model()
    errors = []
    with scratch_results(tmp_path):
        for mod, args in ((jps, (jcfg, jparams)), (tps, (cfg, model))):
            monkeypatch.setattr(mod, "BatchedServer",
                                one_row_batching(mod.BatchedServer))
            with pytest.raises(RuntimeError) as e:
                mod.run_batched_prefill(*args, fast=True, verbose=False)
            errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert errors[0].startswith("batched prefill failed to reduce forwards")


def test_teacher_forced_prefix_keeps_the_counters(runs, tmp_path,
                                                  monkeypatch):
    """``teacher_force=True`` serves the compared run once more fed the
    reference run's tokens: the gate reads that run, the free-running
    agreement is kept beside it, and no other field moves."""
    monkeypatch.setattr(tcommon, "RESULTS", tmp_path)
    cfg, model = reference_model()
    free, _, _, _ = runs["prefix"]
    forced = tps.run_prefix(cfg, model, fast=True, verbose=False,
                            teacher_force=True)
    assert forced["token_agreement_on_vs_off"] == 1.0
    assert (forced.pop("token_agreement_free_running")
            == free["token_agreement_on_vs_off"])
    assert comparable(forced, "prefix") == comparable(free, "prefix")


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(tcommon, "RESULTS", tmp_path)
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tps.main(["--fast", "--workload", "prefix"])
    res = tps.main(["--fast", "--workload", "prefix", "--device", "cpu"])
    assert res["prefill_forwards_on"] < res["prefill_forwards_off"]
