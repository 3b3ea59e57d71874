"""Port parity, the MoE family: ``models.moe`` against the reference's
``repro.models.moe`` on the same numpy-seeded inputs and the JAX init —
the router (softmax and DeepSeek-V3's sigmoid; indices exact, weights and
both aux losses within 1e-6), constructed ties (the lower expert index
first, as ``jax.lax.top_k``), capacity-bounded scatter with dropped
assignments and ``eval_all`` (1e-5); then llama4-maverick-smoke as a
whole (one segment of pattern ((attn, mlp), (attn, moe)) x 2): the
cache-free forward and a padded chunk prefill plus decode steps on paged
float, int8 and int4 pools through both attention routes (1e-4, the
summed ``moe_lb_loss`` equal), weight and residual fake-quant block by
block, and ``quantize_param_tree``'s grids byte for byte."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (perturbed_jax_params,  # noqa: E402
                           policy_quants, quantized_blocks_match,
                           quantized_tree_matches, t, tie_flips,
                           torch_model, unstack_layers, weight_policies)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_smoke_config as jsmoke  # noqa: E402
from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.core.paged_kv import PagedCacheSpec as JSpec  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant.apply import build_model_quant as jbuild  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.core.qtensor import unpack_bits  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.quant.apply import build_model_quant  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
LLAMA = "llama4-maverick-400b-a17b"
ARCHS = [LLAMA, "deepseek-v3-671b", "jamba-v0.1-52b"]
_BITS = {"fp": 0, "int8": 8, "int4": 4}


def _cfgs(arch, **kw):
    return (dataclasses.replace(jsmoke(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _moe_pair(arch, seed=0, ties=False, **kw):
    """(jax cfg, port cfg, jax MoE params, port MoE) from the reference's
    init_moe, the router redrawn at std 2/sqrt(D) (decisive routing);
    ``ties`` copies expert 2j's router column into 2j+1, so every token's
    logits tie in pairs."""
    jcfg, tcfg = _cfgs(arch, **kw)
    tree = jax.tree_util.tree_map(
        np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 11)
    D, E = tree["router"].shape
    router = rng.normal(0, 2 / np.sqrt(D), (D, E)).astype(np.float32)
    if ties:
        router[:, 1::2] = router[:, 0::2]
    tree["router"] = router
    m = tmoe.MoE(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        m.router.copy_(t(tree["router"]))
        for n in ("w_gate", "w_up", "w_down"):
            getattr(m, n).copy_(t(tree["experts"][n]))
            if m.shared is not None:
                getattr(m.shared, n).copy_(t(tree["shared"][n]))
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), m


def _x(cfg, B=2, S=8, seed=3):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True], ids=["seeded", "ties"])
@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch, ties):
    """Softmax (llama4, jamba) and sigmoid (deepseek-v3) routers: indices
    exact, weights and the load-balance and z losses within 1e-6; with
    every token's logits tied in pairs, each pair's lower index wins."""
    jcfg, tcfg, jp, m = _moe_pair(arch, ties=ties)
    x = _x(tcfg, S=16)
    jw, ji, jaux = jmoe._route(jp, jnp.asarray(x), jcfg)
    tw, ti, taux = tmoe._route(m, t(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-6, atol=1e-6)
    if ties:
        # the lower of two tied experts is chosen, the upper one only
        # after it (top-1: never)
        idx = ti.numpy()
        assert (idx[..., 0] % 2 == 0).all()
        if tcfg.experts_per_token > 1:
            pairs = idx[..., 1] == idx[..., 0] + 1
            assert pairs.any()


@pytest.mark.parametrize("k", [1, 2, 8])
def test_stable_topk_breaks_ties_to_the_lower_index(k):
    """Heavily tied scores (3 distinct values over 16 experts): the same
    values and indices as ``jax.lax.top_k``."""
    x = np.random.default_rng(k).integers(0, 3, (64, 16)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), k)
    tv, ti = tmoe.stable_topk(t(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("mode,cf", [("eval_all", 1.25), ("scatter", 1.25),
                                     ("scatter", 0.5)],
                         ids=["eval_all", "scatter", "scatter-drops"])
@pytest.mark.parametrize("arch", [LLAMA, "deepseek-v3-671b"])
def test_moe_apply_matches_reference(arch, mode, cf):
    """The dispatch modes against the reference at 1e-5, the shared expert
    included; at capacity factor 0.5 some assignments are dropped."""
    jcfg, tcfg, jp, m = _moe_pair(arch, moe_capacity_factor=cf)
    x = _x(tcfg)
    jy, jaux = jmoe.moe_apply(jp, jnp.asarray(x), cfg=jcfg, mode=mode)
    ty, taux = tmoe.moe_apply(m, t(x), cfg=tcfg, mode=mode)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert float(taux["moe_lb_loss"]) == pytest.approx(
        float(jaux["moe_lb_loss"]), rel=1e-6, abs=1e-6)
    if cf < 1:
        _, idx, _ = tmoe._route(m, t(x), tcfg)
        T, k, E = x.shape[0] * x.shape[1], tcfg.experts_per_token, \
            tcfg.num_experts
        C = max(1, int(np.ceil(T * k / E * cf)))
        load = np.bincount(idx.numpy().ravel(), minlength=E)
        assert (load > C).any(), "the case drops nothing"
        ev, _ = tmoe.moe_apply(m, t(x), cfg=tcfg, mode="eval_all")
        assert not torch.allclose(ev, ty, rtol=1e-4, atol=1e-4)


def test_moe_scatter_matches_eval_all_without_drops():
    """The reference's test of the same name, on the port: with capacity
    to spare, scatter equals eval_all."""
    _, tcfg, _, m = _moe_pair("jamba-v0.1-52b", moe_capacity_factor=8.0)
    x = t(np.random.default_rng(1).normal(
        size=(2, 32, tcfg.d_model)).astype(np.float32))
    y_ref, _ = tmoe.moe_apply(m, x, cfg=tcfg, mode="eval_all")
    y_sc, _ = tmoe.moe_apply(m, x, cfg=tcfg, mode="scatter")
    np.testing.assert_allclose(y_ref.numpy(), y_sc.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_moe_refusals_and_init():
    """An unknown mode raises; the init draws the reference's distributions: the expert
    stacks' fan-in is their expert axis (std 0.88/sqrt(E) after the +-2
    truncation), ``w_down``'s std 0.88/sqrt(F), the router's 0.88 * 0.02,
    and init_model is a function of its seed."""
    _, tcfg, _, m = _moe_pair(LLAMA)
    x = t(_x(tcfg))
    with pytest.raises(ValueError, match="moe mode"):
        tmoe.moe_apply(m, x, cfg=tcfg, mode="dense")
    cfg = dataclasses.replace(get_smoke_config(LLAMA), num_experts=64,
                              d_model=128, moe_d_ff=256)
    model = ttr.init_model(cfg, seed=5, device="cpu")
    moe = model.layers[1].mlp
    assert isinstance(moe, tmoe.MoE) and not isinstance(model.layers[0].mlp,
                                                        tmoe.MoE)
    E, F = cfg.num_experts, cfg.moe_d_ff
    for w, std in ((moe.w_gate, 0.88 / np.sqrt(E)),
                   (moe.w_up, 0.88 / np.sqrt(E)),
                   (moe.w_down, 0.88 / np.sqrt(F)),
                   (moe.router, 0.88 * 0.02)):
        assert abs(float(w.std()) - std) < 0.05 * std
    again = ttr.init_model(cfg, seed=5, device="cpu")
    assert torch.equal(again.layers[3].mlp.w_up, model.layers[3].mlp.w_up)


# ---------------------------------------------------------------------------
# llama4-maverick-smoke as a whole
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg, jparams, tree = perturbed_jax_params(LLAMA, seed=1, jit=True)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def test_converter_layout(llama):
    """One segment of pattern ((attn, mlp), (attn, moe)) x 2: layer
    p * 2 + j holds period p of position j."""
    jcfg, tcfg, jparams, model = llama
    assert ttr.layer_segments(tcfg) == jtr.layer_segments(jcfg) == [
        ((("attn", "mlp"), ("attn", "moe")), 2, 0)]
    seg = jparams["segments"][0]
    for li, blk in enumerate(model.layers):
        p, j = divmod(li, 2)
        ffn = seg[j]["ffn"]
        if j:
            np.testing.assert_array_equal(
                blk.mlp.w_down.numpy(),
                np.asarray(ffn["experts"]["w_down"][p]))
            np.testing.assert_array_equal(
                blk.mlp.shared.w_up.numpy(),
                np.asarray(ffn["shared"]["w_up"][p]))
        else:
            np.testing.assert_array_equal(blk.mlp.w_down.numpy(),
                                          np.asarray(ffn["w_down"][p]))
        np.testing.assert_array_equal(blk.attn.wq.numpy(),
                                      np.asarray(seg[j]["mixer"]["wq"][p]))


def test_forward_matches_reference(llama):
    """The cache-free forward (attend_full at S = 10): hidden, logits and
    the summed moe_lb_loss."""
    jcfg, tcfg, jparams, model = llama
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 10))
    tok = tok.astype(np.int32)
    th, tlog, _, taux = ttr.forward(model, t(tok), tcfg)
    jh, jlog, _, jaux = jtr.forward(jparams, {"tokens": jnp.asarray(tok)},
                                    jcfg)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert float(taux["moe_lb_loss"]) == pytest.approx(
        float(jaux["moe_lb_loss"]), rel=1e-5)
    assert float(taux["moe_lb_loss"]) > 0


def _kv_quants(jcfg, tcfg, container):
    bits = _BITS[container]
    if not bits:
        return None, None
    names = [f"layer_{i:03d}" for i in range(tcfg.num_layers)]
    tq = build_model_quant(
        PrecisionPolicy.uniform(names, None, FixedPointFormat(2, bits - 2)),
        tcfg, quantize_activations=False, kv_container=container)
    jq = jbuild(JPolicy.uniform(names, None, JFormat(2, bits - 2)), jcfg,
                quantize_activations=False, kv_container=container)
    return tq, jq


class LockstepWriter:
    """Stands in for ``models.attention.paged_update`` in a lockstep run:
    the port's forward reads pools that already hold the reference's
    bytes for this step, so both attend over identical pages; the port's
    own write goes to a copy (``would``), and the float K/V it quantized
    to ``floats`` (a float32 pool of the same geometry, written by the
    same writer), so its bytes compare with the reference's, rounding
    ties aside (:func:`_torch_parity.tie_flips`)."""

    def __init__(self, real):
        self.real, self.would, self.floats = real, [], []

    def __call__(self, pool, k, v, page_table, pos, **kw):
        would = {n: a.clone() for n, a in pool.items()}
        self.would.append(self.real(would, k, v, page_table, pos, **kw))
        shape = (pool["k_scale"].shape[0], kw["page_size"]) + k.shape[2:]
        fl = {"k_pages": torch.zeros(shape), "v_pages": torch.zeros(shape),
              "k_scale": torch.ones(shape[0]),
              "v_scale": torch.ones(shape[0])}
        self.floats.append(self.real(
            fl, k.float(), v.float(), page_table, pos,
            **dict(kw, container="fp", int_bits=None, frac_bits=None,
                   scale_mode="static")))
        return pool


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
@pytest.mark.parametrize("container", ["fp", "int8", "int4"])
def test_paged_prefill_decode_matches_reference(llama, container,
                                                attn_impl, monkeypatch):
    """A padded chunk prefill, a chunk starting mid-page, then decode
    steps on paged pools (page size 8) at G = 2, in lockstep: each step
    the port attends over the reference's pools as they stand after the
    reference's step, so its hidden states and logits hold at 1e-4 and
    moe_lb_loss is equal; its own writes equal the reference's pages
    (float pages at 1e-4, integer pages byte for byte but for one grid
    step at a float rounding tie, where the two packages' K/V differ by
    ULPs)."""
    jcfg, tcfg, jparams, model = llama
    tq, jq = _kv_quants(jcfg, tcfg, container)
    PS, NP, B = 8, 4, 2
    num_pages = 1 + B * NP + 3
    rng = np.random.default_rng(_BITS[container] + len(attn_impl))
    ids = np.arange(1, num_pages)
    rng.shuffle(ids)
    table = ids[:B * NP].reshape(B, NP).astype(np.int32)
    jcaches = jtr.init_cache(jcfg, B, NP * PS, jq, paged=JSpec(PS, num_pages))
    jimpl = {"gather": "gather", "kernel": "pallas"}[attn_impl]
    steps = [(11, [0, 3], [11, 7]), (6, [11, 10], [6, 6]),
             (1, [17, 16], None), (1, [18, 17], None)]
    flips = 0
    for S, start, valid in steps:
        tok = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
        start = np.asarray(start, np.int32)
        kw = {} if valid is None else {
            "kv_valid_len": np.asarray(valid, np.int32)}
        jh, jlog, jcaches, jaux = jtr.forward(
            jparams, {"tokens": jnp.asarray(tok)}, jcfg, quant=jq,
            caches=jcaches, cache_pos=jnp.asarray(start),
            page_table=jnp.asarray(table), attn_impl=jimpl,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        ref = [{n: t(a) for n, a in pool.items()}
               for pool in unstack_layers(jcaches, tcfg)]
        writer = LockstepWriter(tattn.paged_update)
        monkeypatch.setattr(tattn, "paged_update", writer)
        th, tlog, _, taux = ttr.forward(
            model, t(tok), tcfg, quant=tq,
            caches=[{n: a.clone() for n, a in p.items()} for p in ref],
            cache_pos=t(start), page_table=t(table), attn_impl=attn_impl,
            **{k: t(v) for k, v in kw.items()})
        monkeypatch.undo()
        n = S if valid is None else min(valid)
        np.testing.assert_allclose(th.numpy()[:, :n], np.asarray(jh)[:, :n],
                                   **TOL)
        np.testing.assert_allclose(tlog.numpy()[:, :n],
                                   np.asarray(jlog)[:, :n], **TOL)
        assert float(taux["moe_lb_loss"]) == pytest.approx(
            float(jaux["moe_lb_loss"]), rel=1e-5)
        assert len(writer.would) == tcfg.num_layers
        for li, (got, fl, want) in enumerate(zip(writer.would,
                                                 writer.floats, ref)):
            for name in ("k_pages", "v_pages"):
                g, w, f = got[name][1:], want[name][1:], fl[name][1:]
                if container == "fp":
                    np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
                    continue
                if container == "int4":
                    g = unpack_bits(g, 4, tcfg.head_dim)
                    w = unpack_bits(w, 4, tcfg.head_dim)
                flips += tie_flips(g.numpy(), w.numpy(),
                                   f.numpy() * 2.0 ** tq.layer_kv(li)
                                   .frac_bits, (S, li, name))
            for name in ("k_scale", "v_scale"):
                np.testing.assert_array_equal(got[name].numpy(),
                                              want[name].numpy())
    assert flips <= 4, flips


def test_quantized_blocks_match_reference(llama):
    """Weights at Q2.6 / Q1.5 / sentinel / Q3.4 (expert stacks, router and
    shared expert included), residual stream at Q4.12."""
    jcfg, tcfg, jparams, model = llama
    quantized_blocks_match(jcfg, tcfg, jparams, model, *policy_quants(
        jcfg, tcfg, [((2, 6), (4, 12)), ((1, 5), (4, 12)),
                     (None, (4, 12)), ((3, 4), (4, 12))]))


def test_quantize_param_tree_matches_reference(llama):
    """One segment: every layer at the segment's max, Q3.6 (int16)."""
    jcfg, tcfg, jparams, model = llama
    formats = quantized_tree_matches(
        jcfg, tcfg, jparams, model,
        *weight_policies(tcfg, [(2, 6), (1, 5), None, (3, 4)]))
    assert formats == {(3, 6, False)}
