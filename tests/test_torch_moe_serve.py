"""Port parity, serving the MoE and MLA families: on a shared request list
with the JAX init converted to the port, the port's ``BatchedServer``
counts what the reference's counts and its tokens pass the reference
benches' accuracy gate —

* llama4-maverick-smoke (``moe_mode="eval_all"``) on paged pools at
  kv-bits 0, 8 and 4 with bucketed prefill and the prefix cache on
  (prompts share a 20-token system prompt), through the gather route and
  the kernel route (its plain version on the CPU);
* llama4-maverick-smoke in the published ``moe_mode="scatter"``, which
  the server's rule makes stepwise (expert capacity depends on the
  forward's token count);
* deepseek-v3-smoke on dense latent caches at kv-bits 0 and 8, through
  the expanded and the absorbed MLA routes;

and the refusals (a paged MLA cache, bucketed prefill with scatter) raise
the reference's words. The CLI serves both archs on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, torch_model  # noqa: E402

from benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402

CPU = torch.device("cpu")
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)
LLAMA, DSV3 = "llama4-maverick-400b-a17b", "deepseek-v3-671b"
LENS = [25, 9, 30, 1, 21, 40, 13, 26]
SYS = 20                    # a shared system prompt (one full page of 16)

_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jcfg, tcfg, jparams, tree = perturbed_jax_params(arch, seed=2,
                                                         jit=True)
        _MODELS[arch] = jcfg, tcfg, jparams, torch_model(tree, tcfg)
    return _MODELS[arch]


def _requests(cls, vocab, seed=7):
    """8 requests; those longer than the system prompt start with it."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, SYS)
    out = []
    for i, L in enumerate(LENS):
        p = rng.integers(0, vocab, L)
        if L > SYS:
            p[:SYS] = sys_p
        out.append(cls(i, p.astype(np.int32), 3 + i % 3))
    return out


def _counters(srv):
    c = {"prefill_forwards": srv.prefill_forwards,
         "program_launches": srv.program_launches,
         "decode_steps": srv.decode_steps, "cycles": srv.cycles,
         "prefill_tokens": srv.prefill_tokens,
         "prefill_forwards_saved": srv.prefill_forwards_saved,
         "prefill_mode": srv.prefill_mode}
    if srv.paged:
        c.update(allocs=srv.metrics.value("alloc.allocs"),
                 free=srv.allocator.num_free, usable=srv.allocator.num_usable)
    if srv.prefix_cache is not None:
        st = srv.prefix_cache.stats()
        c.update({k: st[k] for k in ("lookups", "hits", "hit_tokens",
                                     "inserted_pages", "cow_copies")})
    return c


def _serve_both(arch, impls, cfg_kw=None, **kw):
    """The reference server, then the port's through each route in
    ``impls``; every port run counts as the reference's and passes the
    gate. Returns the reference server's counters."""
    jcfg, tcfg, jparams, model = _models(arch)
    if cfg_kw:
        jcfg = dataclasses.replace(jcfg, **cfg_kw)
        tcfg = dataclasses.replace(tcfg, **cfg_kw)
    jsrv = JServer(jcfg, jparams, **kw)
    jreqs = jsrv.run(_requests(JRequest, jcfg.vocab_size))
    for impl in impls:
        tsrv = BatchedServer(tcfg, model, attn_impl=impl, device=CPU, **kw)
        treqs = tsrv.run(_requests(Request, tcfg.vocab_size))
        assert all(r.done and r.error is None for r in treqs)
        assert [len(r.out) for r in treqs] == [len(r.out) for r in jreqs]
        assert _counters(tsrv) == _counters(jsrv), impl
        gate = accuracy_gate([r.out for r in jreqs], [r.out for r in treqs],
                             **GATE)
        assert gate["passed"], (impl, gate)
    return _counters(jsrv)


_PAGED = dict(batch_size=3, max_len=64, page_size=16, prefill_bucket=8)


@pytest.mark.parametrize("kv_bits", [0, 8, 4])
def test_llama4_paged_matches_reference(kv_bits):
    """eval_all MoE: bucketed prefill, the prefix cache sharing the system
    prompt's page, both attention routes."""
    c = _serve_both(LLAMA, ("gather", "kernel"), kv_bits=kv_bits,
                    prefix_cache="on", **_PAGED)
    assert c["prefill_mode"] == "bucketed" and c["hits"] >= 3


def test_llama4_scatter_serves_stepwise():
    """The published scatter dispatch: prefill="auto" serves stepwise in
    both packages (the same forwards), int8 pages, both routes."""
    c = _serve_both(LLAMA, ("gather", "kernel"),
                    cfg_kw=dict(moe_mode="scatter"), kv_bits=8, **_PAGED)
    assert c["prefill_mode"] == "stepwise"


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("absorbed", [False, True],
                         ids=["expanded", "absorbed"])
def test_deepseek_dense_matches_reference(absorbed, kv_bits):
    """Dense latent slabs (stepwise prefill through the decode step), the
    sigmoid-routed eval_all MoE layers."""
    c = _serve_both(DSV3, ("gather",), cfg_kw=dict(mla_absorbed=absorbed),
                    kv_bits=kv_bits, batch_size=3, max_len=64)
    assert c["prefill_mode"] == "stepwise"


def test_refusals_use_the_reference_words():
    """A paged MLA cache raises NotImplementedError, and bucketed prefill
    under scatter MoE and fused rounds where prefill is not bucketed (a
    dense cache, scatter MoE) raise ValueError, in the reference's words;
    without experts in scatter mode nothing is refused."""
    for arch, cfg_kw, kw, exc in (
            (DSV3, {}, dict(page_size=16, kv_bits=8), NotImplementedError),
            (LLAMA, dict(moe_mode="scatter"),
             dict(page_size=16, prefill="bucketed"), ValueError),
            (DSV3, {}, dict(kv_bits=8, fused="on"), ValueError),
            (LLAMA, dict(moe_mode="scatter"),
             dict(page_size=16, fused="on"), ValueError)):
        jcfg, tcfg, jparams, model = _models(arch)
        jcfg = dataclasses.replace(jcfg, **cfg_kw)
        tcfg = dataclasses.replace(tcfg, **cfg_kw)
        with pytest.raises(exc) as ref:
            JServer(jcfg, jparams, batch_size=2, max_len=32, **kw)
        with pytest.raises(exc) as port:
            BatchedServer(tcfg, model, batch_size=2, max_len=32, device=CPU,
                          **kw)
        assert str(port.value) == str(ref.value)
    _, tcfg, _, model = _models(LLAMA)
    srv = BatchedServer(tcfg, model, batch_size=2, max_len=32, page_size=16,
                        device=CPU)
    assert srv.prefill_mode == "bucketed"


@pytest.mark.parametrize("argv", [
    ["--arch", LLAMA, "--page-size", "16", "--kv-bits", "8"],
    ["--arch", DSV3, "--kv-bits", "8"]], ids=["llama4", "deepseek-v3"])
def test_cli_serves_on_cpu(argv, capsys):
    reqs = tserve.main(argv + ["--smoke", "--device", "cpu", "--requests",
                               "3", "--batch-size", "2", "--max-new", "3",
                               "--max-len", "32"])
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert "[serve]" in capsys.readouterr().out
