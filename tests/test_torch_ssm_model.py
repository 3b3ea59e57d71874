"""Port parity, the recurrent families as whole models: xlstm-350m-smoke
(one segment of pattern ((mlstm, none), (slstm, none)) x 2, tied
embeddings) and jamba-smoke (one 8-layer period: Mamba layers, a GQA
layer at position 4, eval_all MoE on the odd layers), on the JAX init
converted by ``params_from_numpy`` —

* the converter's layout over the segments;
* the cache-free forward over two chunks (hidden, logits, the summed
  ``moe_lb_loss``) within 1e-4;
* ``prefill``, a chunk continuing from the caches and decode steps on
  dense caches, float and int8 (the int8 runs also put the Mamba and
  mLSTM states on the layers' Q2.6 grid), in lockstep with the
  reference: each step the port reads the reference's caches and states
  as they stand before it, so its hidden states and logits hold at 1e-4
  and its new states and KV writes equal the reference's (float values at
  1e-4, grids but for one step at a float rounding tie);
* jamba on paged float, int8 and int4 pools through both attention
  routes, in lockstep;
* weight and residual fake-quant block by block, ``quantize_param_tree``
  on both trees, and the parameter counts of the full configs."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import (perturbed_jax_params,  # noqa: E402
                           policy_quants, quantized_blocks_match,
                           quantized_tree_matches, t, torch_model,
                           unstack_layers, weight_policies)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import counting as jcounting  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.core.paged_kv import PagedCacheSpec as JSpec  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.quant.apply import build_model_quant as jbuild  # noqa: E402
from repro_torch.configs import counting  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.core.qtensor import unpack_bits  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.quant.apply import build_model_quant  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
XLSTM, JAMBA = "xlstm-350m", "jamba-v0.1-52b"
_BITS = {"fp": 0, "int8": 8, "int4": 4}

_MODELS = {}
# the reference's entry points, compiled once per shape (an eager call
# compiles its layer scan anew each time)
_jforward = jax.jit(jtr.forward, static_argnames=("cfg", "attn_impl"))
_jprefill = jax.jit(jtr.prefill, static_argnames=("cfg", "max_len"))
_jdecode = jax.jit(jtr.decode_step, static_argnames=("cfg",))


@pytest.fixture(scope="module", params=[XLSTM, JAMBA],
                ids=["xlstm", "jamba"])
def arch(request):
    return request.param


def _models(arch):
    if arch not in _MODELS:
        jcfg, tcfg, jparams, tree = perturbed_jax_params(arch, seed=1,
                                                         jit=True)
        _MODELS[arch] = jcfg, tcfg, jparams, torch_model(tree, tcfg)
    return _MODELS[arch]


def _quants(jcfg, tcfg, container):
    """(port, reference) KV quant at Q2.(bits - 2) in ``container``, no
    weight or residual formats (None, None for float)."""
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


def _port_caches(jcaches, tcfg):
    """The reference's caches as the port's per-layer list (copies)."""
    return [{n: t(a) for n, a in c.items()}
            for c in unstack_layers(jcaches, tcfg)]


def _writes_match(got, want, tcfg, label, skip_page0=False):
    """The port's caches after a step against the reference's: float
    tensors within 1e-4; integer grids (KV slabs and pages) and states on
    a grid equal but for single steps at rounding ties, few of them.
    Returns (one-step differences, grid values compared)."""
    flips = n = 0
    for li, (g, w) in enumerate(zip(got, unstack_layers(want, tcfg))):
        for name, wa in w.items():
            ga, wa = g[name], np.asarray(wa)
            if skip_page0 and name.endswith("_pages"):
                ga, wa = ga[1:], wa[1:]
            if ga.dtype == torch.int32:           # int4 lane-packed
                ga = unpack_bits(ga, 4, tcfg.head_dim)
                wa = unpack_bits(torch.from_numpy(wa.copy()), 4,
                                 tcfg.head_dim).numpy()
            ga = ga.float().numpy()
            wa = wa.astype(np.float32)
            if not np.issubdtype(np.asarray(w[name]).dtype, np.integer):
                d = np.abs(ga - wa)
                near = d <= 1e-4 + 1e-4 * np.abs(wa)
                # a state on a grid: one step at a tie (Q2.6 here)
                step = np.abs(d - 2.0 ** -6) <= 1e-6
                assert (near | step).all(), (label, li, name, d.max())
                flips += int((~near).sum())
                n += d.size if name in ("ssm", "C") else 0
                continue
            d = np.abs(ga - wa)
            assert d.max() <= 1, (label, li, name)
            flips += int((d > 0).sum())
            n += d.size
    return flips, n


def _few(counts):
    """One-step differences at ties are rare: the two packages' values
    differ by float ULPs, so at most 1 in 10^4 grid values."""
    flips = sum(f for f, _ in counts)
    n = sum(c for _, c in counts)
    assert flips <= max(1, 1e-4 * n), (flips, n)


def test_converter_layout(arch):
    jcfg, tcfg, jparams, model = _models(arch)
    segs = ttr.layer_segments(tcfg)
    assert segs == jtr.layer_segments(jcfg)
    if arch == XLSTM:
        assert segs == [((("mlstm", "none"), ("slstm", "none")), 2, 0)]
    else:
        assert len(segs) == 1 and segs[0][1] == 1
        assert [s[0] for s in segs[0][0]].count("attn") == 1
    layers = unstack_layers(jparams["segments"], tcfg)
    for li, blk in enumerate(model.layers):
        kind, ffn = blk.sig
        assert (blk.attn is None) == (kind != "attn")
        assert (blk.mlp is None) == (ffn == "none") == (blk.norm2 is None)
        for path, dst in ttr.block_leaves(blk, tcfg):
            src = layers[li]
            for k in path:
                src = src[k]
            np.testing.assert_array_equal(dst.float().numpy(),
                                          np.asarray(src, np.float32))
    assert model.head is None if tcfg.tie_embeddings else True


def test_forward_matches_reference(arch, monkeypatch):
    """The cache-free forward over two chunks of 32, in lockstep: each of
    the port's blocks is fed the reference's input to that block (float32
    drifts ~1e-3 over jamba's residual stream, which its MoE layers carry
    at ~50), and its output, the final hidden states, the logits and the
    summed lb loss hold at 1e-4."""
    jcfg, tcfg, jparams, model = _models(arch)
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 64))
    tok = tok.astype(np.int32)
    x = jnp.asarray(jparams["embed"]["table"])[tok]
    pos = jnp.broadcast_to(jnp.arange(64, dtype=jnp.int32), (2, 64))
    ins, outs = [], []
    for li, lp in enumerate(unstack_layers(jparams["segments"], tcfg)):
        ins.append(np.asarray(x))
        x, _, _ = jtr.block_apply(lp, x, pos, cfg=jcfg,
                                  sig=model.layers[li].sig)
        outs.append(np.asarray(x))
    real, seen = ttr.block_apply, []

    def lockstep(blk, x, *a, **kw):
        li = len(seen)
        y, c, aux = real(blk, t(ins[li]), *a, **kw)
        np.testing.assert_allclose(y.numpy(), outs[li], err_msg=str(li),
                                   **TOL)
        seen.append(li)
        return t(outs[li]), c, aux
    monkeypatch.setattr(ttr, "block_apply", lockstep)
    th, tlog, _, taux = ttr.forward(model, t(tok), tcfg)
    monkeypatch.undo()
    assert seen == list(range(tcfg.num_layers))
    jh, jlog, _, jaux = _jforward(jparams, {"tokens": jnp.asarray(tok)},
                                  cfg=jcfg)
    np.testing.assert_allclose(ins[0], np.asarray(
        jparams["embed"]["table"])[tok])
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert float(taux["moe_lb_loss"]) == pytest.approx(
        float(jaux["moe_lb_loss"]), rel=1e-5, abs=1e-7)


@pytest.mark.parametrize("container", ["fp", "int8"])
def test_dense_prefill_decode_matches_reference(arch, container):
    """``prefill`` over 32 tokens, a chunk of 8 from the caches, then
    decode steps at per-row positions, in lockstep."""
    jcfg, tcfg, jparams, model = _models(arch)
    tq, jq = _quants(jcfg, tcfg, container)
    B, max_len = 2, 48
    rng = np.random.default_rng(_BITS[container] + len(arch))
    tok = rng.integers(0, tcfg.vocab_size, (B, 32)).astype(np.int32)
    jlast, jcaches, _ = _jprefill(jparams, {"tokens": jnp.asarray(tok)},
                                  cfg=jcfg, quant=jq, max_len=max_len)
    tlast, tcaches, nxt = ttr.prefill(model, t(tok), tcfg, quant=tq,
                                      max_len=max_len)
    assert nxt == 32
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    counts = [_writes_match(tcaches, jcaches, tcfg, "prefill")]
    pos = np.asarray([32, 32], np.int32)
    for S in (8, 1, 1, 1):
        tok = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
        before = _port_caches(jcaches, tcfg)
        if S == 1:
            jlog, jcaches = _jdecode(
                jparams, jnp.asarray(tok[:, 0]), jnp.asarray(pos), jcaches,
                cfg=jcfg, quant=jq)
            tlog, tcaches = ttr.decode_step(model, t(tok[:, 0]), t(pos),
                                            before, tcfg, quant=tq)
        else:
            _, jlog, jcaches, _ = _jforward(
                jparams, {"tokens": jnp.asarray(tok)}, cfg=jcfg, quant=jq,
                caches=jcaches, cache_pos=jnp.asarray(pos))
            _, tlog, tcaches, _ = ttr.forward(model, t(tok), tcfg, quant=tq,
                                              caches=before,
                                              cache_pos=t(pos))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        counts.append(_writes_match(tcaches, jcaches, tcfg, ("step", S)))
        pos = pos + S
    _few(counts)


@pytest.mark.parametrize("attn_impl", ["gather", "kernel"])
@pytest.mark.parametrize("container", ["fp", "int8", "int4"])
def test_jamba_paged_matches_reference(container, attn_impl):
    """jamba with its attention layer on paged pools (page size 8, G = 2)
    and its Mamba states dense: a chunk from per-row starts, a chunk
    starting mid-page, then decode steps, in lockstep through each
    route."""
    jcfg, tcfg, jparams, model = _models(JAMBA)
    tq, jq = _quants(jcfg, tcfg, container)
    PS, NP, B = 8, 4, 2
    num_pages = 1 + B * NP + 3
    rng = np.random.default_rng(_BITS[container] + len(attn_impl))
    ids = np.arange(1, num_pages)
    rng.shuffle(ids)
    table = ids[:B * NP].reshape(B, NP).astype(np.int32)
    jcaches = jtr.init_cache(jcfg, B, NP * PS, jq, paged=JSpec(PS, num_pages))
    jimpl = {"gather": "gather", "kernel": "pallas"}[attn_impl]
    counts = []
    for S, start in ((11, [0, 3]), (6, [11, 14]), (1, [17, 20]),
                     (1, [18, 21])):
        tok = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
        start = np.asarray(start, np.int32)
        before = _port_caches(jcaches, tcfg)
        jh, jlog, jcaches, jaux = _jforward(
            jparams, {"tokens": jnp.asarray(tok)}, cfg=jcfg, quant=jq,
            caches=jcaches, cache_pos=jnp.asarray(start),
            page_table=jnp.asarray(table), attn_impl=jimpl)
        th, tlog, tcaches, taux = ttr.forward(
            model, t(tok), tcfg, quant=tq, caches=before,
            cache_pos=t(start), page_table=t(table), attn_impl=attn_impl)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert float(taux["moe_lb_loss"]) == pytest.approx(
            float(jaux["moe_lb_loss"]), rel=1e-5)
        counts.append(_writes_match(tcaches, jcaches, tcfg, (S, container),
                                    skip_page0=True))
    _few(counts)


_FMTS = [((2, 6), (4, 12)), ((1, 5), (4, 12)), (None, (4, 12)),
         ((3, 4), (4, 12))]


def test_quantized_blocks_match_reference(arch):
    """Weights at Q2.6 / Q1.5 / sentinel / Q3.4 over the layers (conv and
    recurrent weights included, decays and biases float), residual stream
    at Q4.12."""
    jcfg, tcfg, jparams, model = _models(arch)
    fmts = (_FMTS * 2)[:tcfg.num_layers]
    quantized_blocks_match(jcfg, tcfg, jparams, model,
                           *policy_quants(jcfg, tcfg, fmts))


def test_quantize_param_tree_matches_reference(arch):
    """One segment: every layer at the segment's max, Q3.6 (int16); the
    SSM leaves by the same rank >= 2 rule (``conv_w`` and ``r`` on the
    grid, ``A_log``, ``dt_bias``, ``D_skip``, ``f_bias`` and ``b``
    passed through)."""
    jcfg, tcfg, jparams, model = _models(arch)
    fmts = ([(2, 6), (1, 5), None, (3, 4)] * 2)[:tcfg.num_layers]
    formats = quantized_tree_matches(jcfg, tcfg, jparams, model,
                                     *weight_policies(tcfg, fmts))
    assert formats == {(3, 6, False)}
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.quant.apply import quantize_param_tree
    tp, _ = weight_policies(tcfg, fmts)
    mixer = quantize_param_tree(model, tp)["layers"][0]["mixer"]
    grid = {"mamba": {"in_proj", "conv_w", "out_proj"},
            "mlstm": {"up_proj", "wq", "wk", "wv", "w_i", "w_f",
                      "down_proj"}}[model.layers[0].sig[0]]
    assert {k for k, v in mixer.items()
            if isinstance(v, QuantizedTensor)} == grid


def test_param_counts_of_the_full_configs():
    """The port's ``count_params`` equals the reference's for the full
    configs."""
    for arch, n in ((XLSTM, 467_141_632), (JAMBA, 51_459_763_200)):
        assert counting.count_params(get_config(arch)) == n
        assert jcounting.count_params(jget_config(arch)) == n


def test_state_quant_reads_the_kv_format():
    """A recurrent layer's state grid is its KV format; a layer whose KV
    stays float keeps a float state."""
    _, tcfg, _, _ = _models(JAMBA)
    names = [f"layer_{i:03d}" for i in range(tcfg.num_layers)]
    tq = build_model_quant(
        PrecisionPolicy.uniform(names, None, FixedPointFormat(2, 6)), tcfg,
        quantize_activations=False, kv_container="int8")
    assert all(tq.layer_state(li) == (2, 6) for li in range(tcfg.num_layers))
    prof = dataclasses.replace(tq, kv_containers=("fp",) + ("int8",) * 7)
    assert prof.layer_state(0) is None and prof.layer_state(1) == (2, 6)
