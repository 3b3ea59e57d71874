"""Port parity, MLA (DeepSeek-V3's latent attention) and deepseek-v3-smoke
as a whole: ``mla_apply`` against the reference's on the same
numpy-seeded inputs and the JAX init, expanded and absorbed, without a
cache and over dense latent caches at kv-bits 0 (the compute dtype) and 8
(the int8 grid of Q2.6), within 1e-4; inside the port, absorbed matches
expanded within 2e-3 (the reference's own test of it). Then the model
(two segments: 1 dense layer, then 3 MoE layers with a sigmoid router;
the MTP module carried): the cache-free forward, prefill plus decode over
dense latent caches on both routes (1e-4, the summed moe_lb_loss equal),
weight and residual fake-quant block by block, ``quantize_param_tree``
with per-segment formats byte for byte, and the refusal of a paged
latent cache in the reference's words.

The cached cases run in lockstep: each step the port reads the latent
slab as the reference's step left it, so both attend over identical
caches, and the port's own write compares with the reference's, one grid
step at a float rounding tie aside."""
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
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant.apply import build_model_quant as jbuild  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.paged_kv import PagedCacheSpec  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.quant.apply import build_model_quant  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
DSV3 = "deepseek-v3-671b"
MAX_LEN = 24
# (tokens per row, start positions): a prompt chunk at a shared clock,
# then decode steps at per-row positions
STEPS = [(7, 0), (1, [7, 5]), (1, [8, 6]), (1, [9, 7])]


def _mla_pair(seed=0, **kw):
    """(jax cfg, port cfg, jax MLA params, port MLAttention) from the
    reference's init_mla, the two norm scales redrawn."""
    jcfg = dataclasses.replace(jsmoke(DSV3), **kw)
    tcfg = dataclasses.replace(get_smoke_config(DSV3), **kw)
    tree = jax.tree_util.tree_map(
        np.asarray, jattn.init_mla(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 5)
    for n in ("q_norm", "kv_norm"):
        tree[n]["scale"] = rng.uniform(
            0.5, 1.5, tree[n]["scale"].shape).astype(np.float32)
    m = tattn.MLAttention(tcfg, torch.float32, "cpu")
    with torch.no_grad():
        for n, a in tree.items():
            getattr(m, n).copy_(t(a["scale"] if n.endswith("_norm") else a))
    return jcfg, tcfg, jax.tree_util.tree_map(jnp.asarray, tree), m


def _kv(bits):
    """(port, reference) KV specs of kv-bits ``bits`` (None at 0)."""
    if not bits:
        return None, None
    return (tattn.KVQuantSpec(2, bits - 2, "int8"),
            jattn.KVQuantSpec(2, bits - 2, "int8"))


def _positions(start, B, S):
    return (np.asarray(start, np.int32).reshape(-1, 1)
            + np.arange(S, dtype=np.int32)[None, :]) * np.ones(
                (B, 1), np.int32)


class LatentWriter:
    """Stands in for ``models.attention.seq_update`` in a lockstep step:
    the live slab keeps the reference's bytes; the port's own write goes
    to a copy (``would``). ``floats`` keeps what ``_q_store`` was given
    (the float latent, before the grid)."""

    def __init__(self, real_update, real_store):
        self.real_update, self.real_store = real_update, real_store
        self.would, self.floats = [], []

    def update(self, buf, new, pos):
        self.would.append(self.real_update(buf.clone(), new, pos))
        return buf

    def store(self, x, quant):
        self.floats.append(x.clone())
        return self.real_store(x, quant)


def _check_write(would, want, fl, bits, label):
    """The port's latent slab after its own write against the
    reference's: float slabs within 1e-4, int8 ones equal but for rounding
    ties. Returns the tie flips."""
    if not bits:
        np.testing.assert_allclose(would.numpy(), want.numpy(), **TOL)
        return 0
    # the float latent, laid out like the slab: written over a float copy
    return tie_flips(would.numpy(), want.numpy(),
                     fl.numpy() * 2.0 ** (bits - 2), label)


@pytest.mark.parametrize("absorbed", [False, True],
                         ids=["expanded", "absorbed"])
def test_mla_without_cache_matches_reference(absorbed):
    jcfg, tcfg, jp, m = _mla_pair()
    B, S = 2, 12
    x = np.random.default_rng(1).normal(
        size=(B, S, tcfg.d_model)).astype(np.float32)
    pos = _positions(0, B, S)
    jy, _ = jattn.mla_apply(jp, jnp.asarray(x), jnp.asarray(pos), cfg=jcfg,
                            absorbed=absorbed)
    ty, cache = tattn.mla_apply(m, t(x), t(pos), cfg=tcfg,
                                absorbed=absorbed)
    assert cache is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_mla_absorbed_matches_expanded():
    """The reference's test of the same name, on the port (2e-3), and
    with a quantized cache over a prompt and a decode step."""
    _, tcfg, _, m = _mla_pair()
    B, S = 2, 24
    x = t(np.random.default_rng(1).normal(
        size=(B, S, tcfg.d_model)).astype(np.float32))
    pos = t(_positions(0, B, S))
    y0, _ = tattn.mla_apply(m, x, pos, cfg=tcfg, absorbed=False)
    y1, _ = tattn.mla_apply(m, x, pos, cfg=tcfg, absorbed=True)
    np.testing.assert_allclose(y0.numpy(), y1.numpy(), rtol=2e-3,
                               atol=2e-3)
    spec, _ = _kv(8)
    outs = []
    for absorbed in (False, True):
        cache = tattn.init_mla_cache(B, 32, tcfg, torch.float32, spec,
                                     "cpu")
        tattn.mla_apply(m, x[:, :20], pos[:, :20], cfg=tcfg, cache=cache,
                        cache_pos=0, kv_quant=spec, absorbed=absorbed)
        y, _ = tattn.mla_apply(m, x[:, 20:21], pos[:, 20:21], cfg=tcfg,
                               cache=cache, cache_pos=20, kv_quant=spec,
                               absorbed=absorbed)
        outs.append(y.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("absorbed", [False, True],
                         ids=["expanded", "absorbed"])
def test_mla_over_dense_cache_matches_reference(absorbed, bits,
                                                monkeypatch):
    """A prompt chunk then decode steps at per-row positions, in lockstep
    with the reference: outputs within 1e-4 and the slab the port writes
    equal to the reference's (int8: byte for byte but for rounding ties);
    the slab is int8 at kv-bits 8, the compute dtype at 0."""
    jcfg, tcfg, jp, m = _mla_pair()
    tspec, jspec = _kv(bits)
    B = 2
    jcache = jattn.init_mla_cache(B, MAX_LEN, jcfg, jnp.float32, jspec)
    tcache = tattn.init_mla_cache(B, MAX_LEN, tcfg, torch.float32, tspec,
                                  "cpu")
    assert tcache["latent"].dtype == (torch.int8 if bits else torch.float32)
    assert tuple(tcache["latent"].shape) == tuple(jcache["latent"].shape)
    rng = np.random.default_rng(bits + absorbed)
    flips = 0
    for S, start in STEPS:
        x = rng.normal(size=(B, S, tcfg.d_model)).astype(np.float32)
        pos = _positions(start, B, S)
        jy, jcache = jattn.mla_apply(
            jp, jnp.asarray(x), jnp.asarray(pos), cfg=jcfg, cache=jcache,
            cache_pos=jnp.asarray(start), kv_quant=jspec, absorbed=absorbed)
        want = t(jcache["latent"])
        w = LatentWriter(tattn.seq_update, tattn._q_store)
        monkeypatch.setattr(tattn, "seq_update", w.update)
        monkeypatch.setattr(tattn, "_q_store", w.store)
        ty, _ = tattn.mla_apply(
            m, t(x), t(pos), cfg=tcfg, cache={"latent": want.clone()},
            cache_pos=t(np.asarray(start, np.int32)), kv_quant=tspec,
            absorbed=absorbed)
        monkeypatch.undo()
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        fl = tattn.seq_update(torch.zeros_like(want, dtype=torch.float32),
                              w.floats[0], t(np.asarray(start, np.int32)))
        flips += _check_write(w.would[0], want, fl, bits, (S, start))
    assert flips <= 2, flips


# ---------------------------------------------------------------------------
# deepseek-v3-smoke as a whole
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dsv3():
    jcfg, tcfg, jparams, tree = perturbed_jax_params(DSV3, seed=1, jit=True)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def test_converter_layout(dsv3):
    """Two segments, ((attn, mlp),) x 1 then ((attn, moe),) x 3; the MTP
    module carried; MLA leaves and norm scales where the reference has
    them."""
    jcfg, tcfg, jparams, model = dsv3
    assert ttr.layer_segments(tcfg) == jtr.layer_segments(jcfg) == [
        ((("attn", "mlp"),), 1, 0), ((("attn", "moe"),), 3, 1)]
    layers = unstack_layers(jparams["segments"], tcfg)
    for blk, ref in zip(model.layers, layers):
        assert isinstance(blk.attn, tattn.MLAttention)
        np.testing.assert_array_equal(blk.attn.wkv_b.numpy(),
                                      np.asarray(ref["mixer"]["wkv_b"]))
        np.testing.assert_array_equal(
            blk.attn.kv_norm.numpy(),
            np.asarray(ref["mixer"]["kv_norm"]["scale"]))
        assert blk.attn.kv_norm.dtype == torch.float32
    np.testing.assert_array_equal(model.mtp.proj.numpy(),
                                  np.asarray(jparams["mtp"]["proj"]))
    np.testing.assert_array_equal(
        model.mtp.block.attn.wq_b.numpy(),
        np.asarray(jparams["mtp"]["block"]["mixer"]["wq_b"]))
    np.testing.assert_array_equal(
        model.mtp.norm.numpy(), np.asarray(jparams["mtp"]["norm"]["scale"]))
    init = ttr.init_model(tcfg, seed=2, device="cpu")
    assert init.mtp is not None and float(init.mtp.norm.min()) == 1.0
    assert float(init.layers[2].attn.q_norm.max()) == 1.0


@pytest.mark.parametrize("absorbed", [False, True],
                         ids=["expanded", "absorbed"])
def test_forward_matches_reference(dsv3, absorbed):
    jcfg, tcfg, jparams, model = dsv3
    jcfg = dataclasses.replace(jcfg, mla_absorbed=absorbed)
    tcfg = dataclasses.replace(tcfg, mla_absorbed=absorbed)
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 10))
    tok = tok.astype(np.int32)
    th, tlog, _, taux = ttr.forward(model, t(tok), tcfg)
    jh, jlog, _, jaux = jtr.forward(jparams, {"tokens": jnp.asarray(tok)},
                                    jcfg)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert float(taux["moe_lb_loss"]) == pytest.approx(
        float(jaux["moe_lb_loss"]), rel=1e-5)


def _model_quants(jcfg, tcfg, bits):
    if not bits:
        return None, None
    names = [f"layer_{i:03d}" for i in range(tcfg.num_layers)]
    tq = build_model_quant(
        PrecisionPolicy.uniform(names, None, FixedPointFormat(2, bits - 2)),
        tcfg, quantize_activations=False)
    jq = jbuild(JPolicy.uniform(names, None, JFormat(2, bits - 2)), jcfg,
                quantize_activations=False)
    return tq, jq


@pytest.mark.parametrize("bits", [0, 8])
@pytest.mark.parametrize("absorbed", [False, True],
                         ids=["expanded", "absorbed"])
def test_prefill_decode_matches_reference(dsv3, absorbed, bits,
                                          monkeypatch):
    """A prompt chunk then decode steps at per-row positions over dense
    latent caches, in lockstep: hidden and logits within 1e-4, moe_lb_loss
    equal, every layer's latent write equal (int8: but for ties)."""
    jcfg, tcfg, jparams, model = dsv3
    jcfg = dataclasses.replace(jcfg, mla_absorbed=absorbed)
    tcfg = dataclasses.replace(tcfg, mla_absorbed=absorbed)
    tq, jq = _model_quants(jcfg, tcfg, bits)
    B = 2
    jcaches = jtr.init_cache(jcfg, B, MAX_LEN, jq)
    tcaches = ttr.init_cache(tcfg, tq, None, "cpu", batch=B,
                             max_len=MAX_LEN)
    assert [c["latent"].dtype for c in tcaches] == [
        torch.int8 if bits else torch.float32] * tcfg.num_layers
    rng = np.random.default_rng(bits + absorbed)
    flips = 0
    for S, start in STEPS:
        tok = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
        jh, jlog, jcaches, jaux = jtr.forward(
            jparams, {"tokens": jnp.asarray(tok)}, jcfg, quant=jq,
            caches=jcaches, cache_pos=jnp.asarray(start))
        ref = [t(c["latent"]) for c in unstack_layers(jcaches, tcfg)]
        w = LatentWriter(tattn.seq_update, tattn._q_store)
        monkeypatch.setattr(tattn, "seq_update", w.update)
        monkeypatch.setattr(tattn, "_q_store", w.store)
        th, tlog, _, taux = ttr.forward(
            model, t(tok), tcfg, quant=tq,
            caches=[{"latent": r.clone()} for r in ref],
            cache_pos=t(np.asarray(start, np.int32)))
        monkeypatch.undo()
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert float(taux["moe_lb_loss"]) == pytest.approx(
            float(jaux["moe_lb_loss"]), rel=1e-5)
        assert len(w.would) == tcfg.num_layers
        for li, (would, fl, want) in enumerate(zip(w.would, w.floats, ref)):
            fl = tattn.seq_update(torch.zeros_like(want, dtype=torch.float32),
                                  fl, t(np.asarray(start, np.int32)))
            flips += _check_write(would, want, fl, bits, (S, li))
    assert flips <= 4, flips


def test_quantized_blocks_match_reference(dsv3):
    """Weights at Q2.6 / Q1.5 / sentinel / Q3.4 (MLA projections, expert
    stacks, router and shared expert included), residual stream at
    Q4.12."""
    jcfg, tcfg, jparams, model = dsv3
    quantized_blocks_match(jcfg, tcfg, jparams, model, *policy_quants(
        jcfg, tcfg, [((2, 6), (4, 12)), ((1, 5), (4, 12)),
                     (None, (4, 12)), ((3, 4), (4, 12))]))


def test_quantize_param_tree_per_segment(dsv3):
    """Two segments, two formats: layer 0 alone at Q1.3 (packed), layers
    1-3 at their max Q3.6 (int16); a single model-wide max would put
    layer 0 on Q3.6 too."""
    jcfg, tcfg, jparams, model = dsv3
    formats = quantized_tree_matches(
        jcfg, tcfg, jparams, model,
        *weight_policies(tcfg, [(1, 3), (2, 6), (3, 4), None]))
    assert formats == {(1, 3, True), (3, 6, False)}


def test_paged_latent_cache_raises_as_the_reference(dsv3):
    jcfg, tcfg, _, _ = dsv3
    with pytest.raises(NotImplementedError) as ref:
        jtr.init_cache(jcfg, 2, 32, None, paged=JSpec(8, 9))
    with pytest.raises(NotImplementedError) as port:
        ttr.init_cache(tcfg, None, PagedCacheSpec(8, 9), "cpu")
    assert str(port.value) == str(ref.value)
