"""Test-side half of the tensor-parallel family tests
(``tests/test_torch_tp_families.py`` at tp = 2, ``tests/test_torch_tp4.py``
at tp = 4): each case's model (the reference's init, perturbed, converted
to the port), the reference's runs, the port's tp = 1 runs, the ranks'
inputs, and the checks of what the ranks return
(``_torch_tp_ranks.serve_families``).

The reference's single-device server is the parity target (its own mesh
server fails on this JAX: ``tests/test_serving_mesh.py::
test_tp2_serving_token_identity``). An attention-only case is
teacher-forced by the reference's tokens at tp = 1 and tp > 1. A
recurrent case minds C3 (the reference carries a slot's recurrent state
over from its last request, so its batched tokens are not the right
ones): tp > 1 is held against the port's tp = 1 batched run, teacher-
forced by its tokens, and each request served alone against the
reference's alone-served run, teacher-forced by its tokens."""
from __future__ import annotations

import numpy as np
import torch

import _torch_tp_ranks as ranks
from _torch_parity import perturbed_jax_params, torch_model

from repro.launch.serve import BatchedServer as JServer
from repro.launch.serve import Request as JRequest
from repro_torch.core.paged_kv import PagedCacheSpec, max_pages_per_seq
from repro_torch.models.transformer import init_cache
from repro_torch.parallel.sharding import (AbstractMesh, paged_pool_specs,
                                           plan_for_mesh)

TOL = 1e-4
_MODELS = {}


def model(arch, over=None):
    """(jax config, port config, jax params, port model) of ``arch``'s
    smoke config with ``over`` replaced, its init perturbed (seed 2)."""
    key = (arch, tuple(sorted((over or {}).items())))
    if key not in _MODELS:
        jcfg, tcfg, jparams, tree = perturbed_jax_params(
            arch, seed=2, jit=True, over=over)
        _MODELS[key] = jcfg, tcfg, jparams, torch_model(tree, tcfg)
    return _MODELS[key]


def requests(vocab, *, lens, max_new, prefixes=0, seed=3):
    """(rid, prompt, max_new) triples; with ``prefixes`` > 0 each prompt
    starts with one of that many shared 16-token system prompts."""
    rng = np.random.default_rng(seed)
    pre = [rng.integers(0, vocab, 16).tolist() for _ in range(prefixes)]
    return [(i, (pre[i % prefixes] if prefixes else [])
             + rng.integers(0, vocab, n).tolist(), max_new)
            for i, n in enumerate(lens)]


class JTap:
    """Records the reference server's step logits, as ``DecodeTap``."""

    def __init__(self, srv):
        self.srv, self.fn, self.logits = srv, srv.decode, {}

    def __call__(self, params, tokens, pos, caches, pt):
        live = [(i, r) for i, r in enumerate(self.srv.slots) if r is not None]
        nxt, logits, caches = self.fn(params, tokens, pos, caches, pt)
        arr = np.asarray(logits)
        for i, r in live:
            self.logits[(r.rid, self.srv.slot_gen[i])] = arr[i]
        return nxt, logits, caches


def _jrun(jsrv, reqs):
    tap = JTap(jsrv)
    jsrv.decode = tap
    done = jsrv.run([JRequest(r, np.asarray(p, np.int32), m)
                     for r, p, m in reqs])
    return {"tokens": {r.rid: list(r.out) for r in done},
            "logits": tap.logits, "counters": ranks.host_counters(jsrv)}


def _ref_kw(kw):
    return dict(kw, attn_impl="gather")


def prepare(cases: dict, state_dir) -> dict:
    """Every case's reference and tp = 1 runs and the ranks' inputs.
    ``cases``: {name: {"arch", "over", "kw", "requests", "recurrent"}}."""
    out = {"ref": {}, "one": {}, "rank_cases": {}, "cfg": {}}
    paths = {}
    for name, c in cases.items():
        jcfg, tcfg, jparams, tmodel = model(c["arch"], c.get("over"))
        reqs = c["requests"]
        key = (c["arch"], tuple(sorted((c.get("over") or {}).items())))
        if key not in paths:
            paths[key] = str(state_dir / f"model{len(paths)}.pt")
            torch.save(tmodel.state_dict(), paths[key])
        ref = _jrun(JServer(jcfg, jparams, **_ref_kw(c["kw"])), reqs)
        rank_case = {"cfg": tcfg, "path": paths[key], "kw": c["kw"],
                     "requests": reqs}
        if c.get("recurrent"):
            # C3: the port's own batched run forces tp > 1; each request
            # served alone is held against the reference's alone runs
            toks, logits, counters, _ = ranks.serve_case(
                tcfg, tmodel, c["kw"], reqs, None)
            forced = {r: t for (r, _, _), t in zip(reqs, toks)}
            jone = JServer(jcfg, jparams,
                           **_ref_kw(dict(c["kw"], batch_size=1)))
            fresh = jone.caches
            alone = {"tokens": {}, "logits": {}}
            for r in reqs:
                jone.caches = fresh
                got = _jrun(jone, [r])
                alone["tokens"].update(got["tokens"])
                alone["logits"].update(got["logits"])
            ref["alone"] = alone
            rank_case["alone"] = alone["tokens"]
        else:
            forced = ref["tokens"]
            toks, logits, counters, _ = ranks.serve_case(
                tcfg, tmodel, c["kw"], reqs, forced)
        rank_case["forced"] = forced
        out["ref"][name] = ref
        out["one"][name] = {"tokens": toks, "logits": logits,
                            "counters": counters}
        out["rank_cases"][name] = rank_case
        out["cfg"][name] = tcfg
    return out


def worst(got: dict, want: dict) -> float:
    """The largest |difference| over step logits keyed alike."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    return max(float(np.abs(np.asarray(g) - np.asarray(want[k])).max())
               for k, g in got.items())


def expected_layout(cfg, kw, tp) -> list:
    """Each cache leaf's local shape and mark on a (1, ``tp``) mesh, from
    ``paged_pool_specs`` over the whole caches (on the meta device)."""
    plan = plan_for_mesh(AbstractMesh((1, tp), ("data", "model")))
    ps, B, T = kw["page_size"], kw["batch_size"], kw["max_len"]
    pages = kw.get("num_pages") or 1 + B * max_pages_per_seq(T, ps)
    whole = init_cache(cfg, _quant_of(cfg, kw),
                       PagedCacheSpec(page_size=ps, num_pages=pages),
                       "meta", batch=B, max_len=T)
    out = []
    for layer, specs in zip(whole, paged_pool_specs(whole, plan)):
        lay = {}
        for k, t in layer.items():
            dims = [d for d, ax in enumerate(specs[k]) if ax == "model"]
            shape = tuple(n // tp if d in dims else n
                          for d, n in enumerate(t.shape))
            lay[k] = (shape, dims[0] if dims else None)
        out.append(lay)
    return out


def _quant_of(cfg, kw):
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.quant.apply import (build_model_quant,
                                         transformer_layer_names)
    bits = kw.get("kv_bits", 0)
    if not bits:
        return None
    return build_model_quant(
        PrecisionPolicy.uniform(transformer_layer_names(cfg), None,
                                FixedPointFormat(2, bits - 2)),
        cfg, quantize_kv=True, quantize_activations=False,
        kv_container="int4" if bits <= 4 else "int8")


def check_case(name: str, prep: dict, got: list, tp: int, *,
               recurrent: bool) -> dict:
    """The checks of one case over every rank's result ``got``: step
    logits within 1e-4 of tp = 1's (and of the reference's, or of its
    alone runs for a recurrent case), tokens alike on every rank, every
    host counter equal to tp = 1's (and tp = 1's to the reference's where
    both count), page scales equal on every rank, each cache leaf sharded
    or whole as ``paged_pool_specs`` says. Returns the worst differences
    and rank 0's counters."""
    ref, one = prep["ref"][name], prep["one"][name]
    r0 = got[0][name]
    diffs = {"tp1": worst(r0["logits"], one["logits"])}
    if recurrent:
        diffs["ref_alone"] = worst(r0["alone_logits"],
                                   ref["alone"]["logits"])
    else:
        diffs["ref"] = worst(r0["logits"], ref["logits"])
    print(f"[tp{tp}] {name}: {len(r0['logits'])} step logits, max |diff| "
          f"{diffs}")
    assert max(diffs.values()) < TOL, diffs
    for res in got:
        assert res[name]["tokens"] == r0["tokens"]
        assert res[name]["counters"] == one["counters"]
        for a, b in zip(res[name]["scales"], r0["scales"]):
            np.testing.assert_array_equal(a, b)
    shared = set(ref["counters"]) & set(one["counters"])
    assert len(shared) > 10
    assert {k: one["counters"][k] for k in shared} == \
        {k: ref["counters"][k] for k in shared}
    cfg = prep["cfg"][name]
    kw = prep["rank_cases"][name]["kw"]
    assert r0["layout"] == expected_layout(cfg, kw, tp)
    return {"diffs": diffs, "counters": r0["counters"]}
