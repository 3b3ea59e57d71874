"""Port parity, serving: on a shared request list with the JAX init
converted to the port, the port's ``BatchedServer`` (paged, page size 16,
bucketed batched prefill) counts the same prefill forwards, programs,
decode steps and page allocations as the reference server at kv-bits
{0, 8, 4}, and its tokens pass the reference benches' accuracy gate —
through the gather route and the kernel route (plain version on the CPU).
Inside the port, bucketed == stepwise and batched == sequential prefill
give identical tokens."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, torch_model  # noqa: E402

from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.core.paged_kv import OutOfPagesError  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402

CPU = torch.device("cpu")
# prompt lengths straddle the bucket-8 boundaries (1 = no prefill at all,
# 21 = chunks 8 + 8 + 4) and stack same-bucket rows in one admission wave
LENS = [9, 9, 1, 21, 5, 8, 13, 3]
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=2)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def _requests(cls, vocab, lens=LENS, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, L).astype(np.int32), 4 + i % 3)
            for i, L in enumerate(lens)]


_KW = dict(batch_size=3, max_len=48, page_size=16, prefill_bucket=8)


def _counters(srv):
    return {"prefill_forwards": srv.prefill_forwards,
            "program_launches": srv.program_launches,
            "decode_steps": srv.decode_steps, "cycles": srv.cycles,
            "prefill_tokens": srv.prefill_tokens,
            "allocs": srv.metrics.value("alloc.allocs"),
            "free": srv.allocator.num_free,
            "usable": srv.allocator.num_usable}


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_serving_matches_reference(models, kv_bits):
    jcfg, tcfg, jparams, model = models
    jsrv = JServer(jcfg, jparams, kv_bits=kv_bits, prefill="bucketed",
                   **_KW)
    jreqs = jsrv.run(_requests(JRequest, jcfg.vocab_size))
    for impl in ("gather", "kernel"):
        tsrv = BatchedServer(tcfg, model, kv_bits=kv_bits,
                             prefill="bucketed", attn_impl=impl,
                             device=CPU, **_KW)
        treqs = tsrv.run(_requests(Request, tcfg.vocab_size))
        assert all(r.done for r in treqs)
        assert [len(r.out) for r in treqs] == [len(r.out) for r in jreqs]
        assert _counters(tsrv) == _counters(jsrv), impl
        gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                             **GATE)
        assert gate["passed"], (impl, gate)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_bucketed_prefill_matches_stepwise(models, kv_bits):
    """Bucketed chunked prefill == token-at-a-time prefill, token for token,
    with strictly fewer prefill forwards."""
    _, tcfg, _, model = models
    outs, fwd = [], []
    for prefill in ("stepwise", "bucketed"):
        srv = BatchedServer(tcfg, model, kv_bits=kv_bits, prefill=prefill,
                            device=CPU, **_KW)
        outs.append([r.out for r in srv.run(
            _requests(Request, tcfg.vocab_size))])
        fwd.append(srv.prefill_forwards)
        assert srv.allocator.num_free == srv.allocator.num_usable
    assert outs[0] == outs[1]
    assert fwd[1] < fwd[0]


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_batched_prefill_matches_sequential(models, kv_bits):
    """Same-bucket rows stacked into one [n, bucket] forward == one prompt
    at a time, token for token, with strictly fewer forwards."""
    _, tcfg, _, model = models
    lens = [9, 9, 9, 5, 21, 9]
    outs, fwd = [], []
    for batch in (1, 4):
        srv = BatchedServer(tcfg, model, kv_bits=kv_bits, prefill="bucketed",
                            prefill_batch=batch, attn_impl="kernel",
                            device=CPU, **dict(_KW, batch_size=4))
        outs.append([r.out for r in srv.run(
            _requests(Request, tcfg.vocab_size, lens))])
        fwd.append(srv.prefill_forwards)
    assert outs[0] == outs[1]
    assert fwd[1] < fwd[0]


def test_admission_rejects_and_defers(models):
    """A request that can never fit is rejected with OutOfPagesError after
    the serviceable traffic drained; one that must wait is deferred."""
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, kv_bits=8, num_pages=3, device=CPU,
                        **dict(_KW, batch_size=2))
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, 256, L).astype(np.int32), 8)
            for i, L in enumerate([20, 20, 40])]
    with pytest.raises(OutOfPagesError) as err:
        srv.run(reqs)
    assert err.value.rid == 2 and err.value.needed == 3
    assert reqs[0].done and reqs[1].done and len(reqs[1].out) == 8
    assert srv.metrics.value("sched.defers") >= 1
    assert srv.allocator.num_free == srv.allocator.num_usable
    with pytest.raises(ValueError, match="max_len"):
        srv.run([Request(9, np.zeros(48, np.int32), 2)])


@pytest.mark.parametrize("option,item", [
    (dict(page_size=0), "6"), (dict(fused="on"), "5"),
    (dict(prefix_cache="on"), "8"), (dict(kv_scale="page"), "8"),
    (dict(kv_offload="host"), "9"), (dict(sched="slo"), "9"),
    (dict(kv_adapt="on"), "9"), (dict(metrics="on"), "8"),
    (dict(tp=2), "13")])
def test_options_outside_the_slice_raise(models, option, item):
    _, tcfg, _, model = models
    kw = dict(_KW, kv_bits=8, device=CPU)
    kw.update(option)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        BatchedServer(tcfg, model, **kw)


def test_server_needs_the_models_device(models):
    _, tcfg, _, model = models
    with pytest.raises((RuntimeError, ValueError)):
        BatchedServer(tcfg, model, **_KW)   # default device is cuda


def test_cli_runs_on_cpu(capsys):
    reqs = tserve.main(["--arch", "qwen2-72b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch-size", "2",
                        "--max-new", "3", "--max-len", "32",
                        "--page-size", "16", "--kv-bits", "4",
                        "--attn-impl", "kernel"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert "[serve]" in capsys.readouterr().out
