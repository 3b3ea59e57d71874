"""Port parity, fused and dense serving: the port's ``BatchedServer`` with
``fused="on"`` (one ragged program per scheduler cycle) and with dense
caches (``page_size=0``) counts the same prefill forwards, programs,
decode steps and cycles as the reference server at kv-bits {0, 8, 4}, and
its tokens pass the reference benches' accuracy gate. Inside the port,
fused == separate programs and paged == dense give identical tokens
(single-threaded torch)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, torch_model  # noqa: E402

from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.core.paged_kv import SCRATCH_PAGE, OutOfPagesError  # noqa: E402,E501
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402

CPU = torch.device("cpu")
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)
# same-bucket admission waves, a multi-chunk prompt (21 = 8 + 8 + 4), a
# one-token chunk (2), a prompt with no prefill (1) and staggered
# retirements: fused cycles cover pure decode (S = 1), mixed prefill +
# decode rows and prefill-only rounds
FUSED_LENS = [9, 9, 5, 21, 9, 1, 2]
DENSE_LENS = [3, 9, 5, 12, 7, 4]
_PAGED = dict(batch_size=4, max_len=48, page_size=8, prefill="bucketed",
              prefill_bucket=8)
_DENSE = dict(batch_size=3, max_len=32)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=5)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def _requests(cls, vocab, lens, seed=13):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(0, vocab, L).astype(np.int32), 5 + i % 3)
            for i, L in enumerate(lens)]


def _counters(srv):
    out = {"prefill_forwards": srv.prefill_forwards,
           "program_launches": srv.program_launches,
           "decode_steps": srv.decode_steps, "cycles": srv.cycles,
           "prefill_tokens": srv.prefill_tokens,
           "prefill_forwards_saved": srv.prefill_forwards_saved,
           "gen_tokens": srv._gen_tokens}
    if srv.paged:
        out.update(allocs=srv.metrics.value("alloc.allocs"),
                   free=srv.allocator.num_free,
                   usable=srv.allocator.num_usable)
    return out


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_fused_matches_separate(models, kv_bits, attn_impl):
    """Fused rounds give the separate-program path's tokens, with one
    program per scheduler cycle and fewer programs in all."""
    _, tcfg, _, model = models
    runs = {}
    for fused in ("off", "on"):
        srv = BatchedServer(tcfg, model, kv_bits=kv_bits, fused=fused,
                            attn_impl=attn_impl, device=CPU, **_PAGED)
        reqs = srv.run(_requests(Request, tcfg.vocab_size, FUSED_LENS))
        assert all(r.done and len(r.out) == r.max_new for r in reqs)
        assert srv.allocator.num_free == srv.allocator.num_usable
        runs[fused] = (srv, [r.out for r in reqs])
    sep, fus = runs["off"][0], runs["on"][0]
    assert runs["on"][1] == runs["off"][1]
    assert fus.program_launches == fus.cycles
    assert fus.program_launches < sep.program_launches
    assert fus._gen_tokens == sep._gen_tokens


@pytest.mark.parametrize("batch_size", [1, 2])
def test_fused_matches_separate_at_small_batch(models, batch_size):
    """Batch 1 decodes through one-row products (torch's CPU GEMV path),
    and prompts of 2 tokens run [1, 1] prefill chunks on the separate
    path that a fused round stacks with other rows: tokens still agree."""
    _, tcfg, _, model = models
    outs = []
    for fused in ("off", "on"):
        srv = BatchedServer(tcfg, model, kv_bits=8, fused=fused,
                            attn_impl="kernel", device=CPU,
                            **dict(_PAGED, batch_size=batch_size))
        outs.append([r.out for r in srv.run(_requests(
            Request, tcfg.vocab_size, [2, 9, 2, 3, 17, 2, 6]))])
    assert outs[0] == outs[1]


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_fused_serving_matches_reference(models, kv_bits):
    """Every host counter of a fused run equals the reference's fused run,
    through both routes; tokens pass the accuracy gate."""
    jcfg, tcfg, jparams, model = models
    jsrv = JServer(jcfg, jparams, kv_bits=kv_bits, fused="on", **_PAGED)
    jreqs = jsrv.run(_requests(JRequest, jcfg.vocab_size, FUSED_LENS))
    assert jsrv.program_launches == jsrv.cycles
    for impl in ("gather", "kernel"):
        tsrv = BatchedServer(tcfg, model, kv_bits=kv_bits, fused="on",
                             attn_impl=impl, device=CPU, **_PAGED)
        treqs = tsrv.run(_requests(Request, tcfg.vocab_size, FUSED_LENS))
        assert [len(r.out) for r in treqs] == [len(r.out) for r in jreqs]
        assert _counters(tsrv) == _counters(jsrv), impl
        gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                             **GATE)
        assert gate["passed"], (impl, gate)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_dense_serving_matches_reference(models, kv_bits):
    """Dense caches (``page_size=0``: stepwise prefill through the shared
    decode step, an int8 slab at every kv-bits > 0) count what the
    reference counts; tokens pass the accuracy gate."""
    jcfg, tcfg, jparams, model = models
    jsrv = JServer(jcfg, jparams, kv_bits=kv_bits, **_DENSE)
    jreqs = jsrv.run(_requests(JRequest, jcfg.vocab_size, DENSE_LENS))
    tsrv = BatchedServer(tcfg, model, kv_bits=kv_bits, device=CPU, **_DENSE)
    treqs = tsrv.run(_requests(Request, tcfg.vocab_size, DENSE_LENS))
    assert not tsrv.paged and tsrv.prefill_mode == "stepwise"
    want = torch.int8 if kv_bits else tcfg.torch_dtype
    assert all(c["k"].dtype == want and c["k"].shape[:2] == (3, 32)
               for c in tsrv.caches)
    assert [len(r.out) for r in treqs] == [len(r.out) for r in jreqs]
    assert _counters(tsrv) == _counters(jsrv)
    gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                         **GATE)
    assert gate["passed"], gate


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_paged_matches_dense(models, kv_bits):
    """Same prefill algorithm (stepwise), two layouts: a paged pool whose
    span equals the dense slab gives the dense cache's tokens bitwise."""
    _, tcfg, _, model = models
    outs = []
    for page_size in (0, 8):
        kw = dict(_DENSE, page_size=page_size, prefill="stepwise")
        srv = BatchedServer(tcfg, model, kv_bits=kv_bits, device=CPU, **kw)
        outs.append([r.out for r in srv.run(
            _requests(Request, tcfg.vocab_size, DENSE_LENS))])
    assert outs[0] == outs[1]


def test_fused_and_dense_option_checks(models):
    """The reference's refusals: fused needs bucketed prefill on a paged
    cache; a dense cache takes neither the kernel route nor bucketed
    prefill, and ``prefill="auto"`` falls back to stepwise there."""
    _, tcfg, _, model = models
    with pytest.raises(ValueError, match="fused"):
        BatchedServer(tcfg, model, kv_bits=8, fused="on", device=CPU,
                      **dict(_PAGED, prefill="stepwise"))
    with pytest.raises(ValueError, match="fused"):
        BatchedServer(tcfg, model, kv_bits=8, fused="on", device=CPU,
                      **_DENSE)
    with pytest.raises(ValueError, match="page-size"):
        BatchedServer(tcfg, model, kv_bits=8, attn_impl="kernel",
                      device=CPU, **_DENSE)
    with pytest.raises(ValueError, match="bucketed"):
        BatchedServer(tcfg, model, kv_bits=8, prefill="bucketed",
                      device=CPU, **_DENSE)
    with pytest.raises(ValueError, match="fused"):
        BatchedServer(tcfg, model, kv_bits=8, fused="yes", device=CPU,
                      **_PAGED)
    srv = BatchedServer(tcfg, model, kv_bits=4, device=CPU, **_DENSE)
    assert srv.prefill_mode == "stepwise" and srv._chunk_prefill is None
    assert srv.quant.kv_container == "int8"


def test_fused_admission_rolls_back_on_out_of_pages(models):
    """An OutOfPagesError inside a fused round rolls back every unfinished
    row: no slot claimed, no page leaked, no reservation outstanding."""
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, kv_bits=8, fused="on", device=CPU,
                        **_PAGED)
    real_alloc, calls = srv.allocator.alloc, {"n": 0}

    def flaky_alloc():
        calls["n"] += 1
        if calls["n"] > 1:   # the second row of the round fails
            raise OutOfPagesError(needed=1, free=0,
                                  total=srv.allocator.num_usable)
        return real_alloc()

    srv.allocator.alloc = flaky_alloc
    reqs = _requests(Request, tcfg.vocab_size, [9, 9])
    with pytest.raises(OutOfPagesError):
        srv.run(reqs)
    srv.allocator.alloc = real_alloc
    assert all(s is None for s in srv.slots)
    assert all(r == 0 for r in srv.slot_reserved)
    assert all(not p for p in srv.slot_pages)
    assert (srv.page_table == SCRATCH_PAGE).all()
    assert srv.allocator.num_free == srv.allocator.num_usable
    assert all(isinstance(r.error, OutOfPagesError) for r in reqs)


@pytest.mark.parametrize("argv", [
    ["--kv-bits", "8"],
    ["--kv-bits", "4", "--page-size", "8", "--fused", "on",
     "--attn-impl", "kernel"]], ids=["dense", "fused"])
def test_cli_dense_and_fused_on_cpu(argv, capsys):
    reqs = tserve.main(["--arch", "qwen2-72b", "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch-size", "2",
                        "--max-new", "3", "--max-len", "32"] + argv)
    assert all(r.done and len(r.out) == 3 for r in reqs)
    out = capsys.readouterr().out
    assert ("dense max_len=32" in out) == (argv[-1] == "8")
    assert ("fused=on" in out) == ("--fused" in argv)
