"""Port parity, ``benchmarks/paged_serve.py``'s overcommit, adapt and
ragged workloads at ``--fast`` on the CPU: the reference's bench with its
own weights against the port's with the same weights converted. Every
field that is not a time, a rate or a token agreement is equal
(preemptions, resumes, re-aliased pages, demotions, promotions, host and
tier peaks, snapshot and restored pages, hit rates, requantizations,
deepens, tier promotions, programs, cycles, decode steps, prefill
forwards, wave-dedupe pages, goodput, trace events, bytes per tier);
both packages' gates pass; their tokens agree per ``accuracy_gate``.
The gates' words are held in ``test_torch_bench_gates.py``."""
import pytest

torch = pytest.importorskip("torch")

from _torch_bench import (GATE, comparable, flat_tokens,  # noqa: E402
                          reference_model, scratch_results)

from benchmarks import paged_serve as jps  # noqa: E402
from repro_torch.benchmarks import paged_serve as tps  # noqa: E402
from repro_torch.benchmarks.lm_precision import accuracy_gate  # noqa: E402

WORKLOADS = ("overcommit", "adapt", "ragged")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("workloads")
    cfg, model = reference_model()
    out = {}
    for w in WORKLOADS:
        with scratch_results(tmp) as (jlog, tlog):
            want = jps.run(fast=True, workload=w, verbose=False)
            got = tps.run(cfg, model, fast=True, workload=w, verbose=False)
        out[w] = (got, want, tlog, jlog)
    return out


@pytest.mark.parametrize("workload", WORKLOADS)
def test_fields_equal_the_reference(runs, workload):
    got, want, _, _ = runs[workload]
    assert (comparable(got, workload)
            == comparable(want, workload, reference=True))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_tokens_agree_with_the_reference(runs, workload):
    _, _, tlog, jlog = runs[workload]
    assert [len(r) for r in tlog] == [len(r) for r in jlog]
    gate = accuracy_gate(flat_tokens(jlog), flat_tokens(tlog), **GATE)
    assert gate["passed"], gate


def test_overcommit_preempts_and_restores(runs):
    got, _, _, _ = runs["overcommit"]
    assert got["preemptions"] == got["resumes"] >= 1
    assert got["rejected"] == 0 and got["completed"] == got["requests"]
    assert got["overcommit_ratio"] > 2
    assert got["restored_pages"] == got["snapshot_pages"] > 0
    assert (got["prefix_hit_rate_restored"]
            >= got["prefix_hit_rate_warm"] - 0.05)
    assert got["trace_path"].endswith("torch_trace_overcommit.json")
    # the inventory after the cold run, before the release
    inv = got["kv_inventory"]
    assert 0 < inv["host_pages"] <= got["host_peak_pages"]
    assert inv["device_bytes"] > 0


def test_adapt_requantizes_before_it_demotes(runs):
    got, _, _, _ = runs["adapt"]
    assert got["demotions_off"] >= 1 and got["requants"] >= 1
    assert got["demotions_on"] == 0
    assert got["token_ratio_vs_off"] >= 2
    assert got["accuracy_gate"]["passed"]


def test_ragged_fused_runs_one_program_a_cycle(runs):
    got, _, _, _ = runs["ragged"]
    assert got["programs_fused"] == got["cycles_fused"]
    assert got["programs_fused"] < got["programs_separate"]
    assert got["prefill_forwards_batched"] < got["prefill_forwards_sequential"]
    assert got["decode_steps_fused"] == got["decode_steps_separate"]
