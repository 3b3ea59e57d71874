"""The port's training path against the reference's single-device
functions: ``train_loss`` (losses and every gradient leaf) on the smoke
archs of every family (the recurrent ones at two chunks, jamba at both
MoE dispatches, the encoder and the VLM from tokens and from a stub
frontend's embeddings), the losses' helpers, C5 (the reference's
quantized training passes no gradient to the weights; the port's
straight-through fake-quant equals the reference with ``fake_quant``
replaced by ``fake_quant_ste``), C8 (the same for the recurrent state's
grid), C7 (the int8 wire's one scale per leaf of the reference's tree).
The train step and the CLI are in ``test_torch_train_step.py``.

Tolerances: losses 1e-5 relative; each gradient leaf within 1e-4 of the
leaf's largest magnitude."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import (perturbed_jax_params,  # noqa: E402
                           ref_state_grid_ste, t, unstack_layers)

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.launch.train import build_quant as jbuild_quant  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch.configs.counting import segment_layers  # noqa: E402
from repro_torch.configs.shapes import SHAPES, make_batch  # noqa: E402
from repro_torch.core.fixedpoint import fake_quant_ste  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer import (params_from_numpy,  # noqa
                                            params_to_numpy,
                                            reference_tree)
from repro_torch.optim.compress import CompressionConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

# "arch:moe_mode" overrides the smoke config's MoE dispatch (jamba-smoke's
# is eval_all; the published config's scatter)
ARCHS = ["qwen2-72b", "llama4-maverick-400b-a17b", "deepseek-v3-671b",
         "qwen2-vl-2b", "xlstm-350m", "jamba-v0.1-52b",
         "jamba-v0.1-52b:scatter", "hubert-xlarge"]


def _arch(arch):
    """perturbed_jax_params of "name[:moe_mode]"."""
    name, _, mode = arch.partition(":")
    jcfg, tcfg, jparams, tree = perturbed_jax_params(name, jit=True)
    if mode:
        jcfg = dataclasses.replace(jcfg, moe_mode=mode)
        tcfg = dataclasses.replace(tcfg, moe_mode=mode)
    return jcfg, tcfg, jparams, tree


def _seq(cfg):
    """A training sequence: two chunks of a recurrent config's mixers
    (a state crosses a chunk boundary), else 16."""
    return 2 * cfg.ssm_chunk if cfg.family in ("ssm", "hybrid") else 16


def _batch(vocab, B=2, S=16, seed=0):
    tok = np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)
    lab = np.concatenate([tok[:, 1:], np.full((B, 1), -100, np.int32)], 1)
    return tok, lab


def _grads(model):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            .numpy() for n, p in model.named_parameters()}


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _trees_match(got, want, tol=1e-4):
    """Every leaf of two gradient trees in the reference's layout within
    ``tol`` of the leaf's largest magnitude."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * scale, (k, err, scale)


def _assert_grads_match(model, tcfg, jgrads, tol=1e-4):
    """Every gradient leaf, restacked into the reference's layout, within
    ``tol`` of the leaf's largest magnitude."""
    _trees_match(reference_tree(_grads(model), model, tcfg), jgrads, tol)


def _port_loss(model, tcfg, batch, quant=None):
    """``train_loss`` and its backward on a numpy batch."""
    for p in model.parameters():
        p.grad = None
    loss, m = ttr.train_loss(model, {k: t(v) for k, v in batch.items()},
                             tcfg, quant=quant)
    loss.backward()
    return loss, m


def _ref_loss(jparams, jcfg, batch, quant=None):
    fn = jax.jit(jax.value_and_grad(lambda p: jtr.train_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        quant=quant), has_aux=True))
    (loss, m), g = fn(jparams)
    return loss, m, g


def _tokens(vocab, **kw):
    tok, lab = _batch(vocab, **kw)
    return {"tokens": tok, "labels": lab}


def _losses_match(m, jm):
    assert set(m) == set(jm)
    for k in m:
        assert float(m[k].detach()) == pytest.approx(float(jm[k]), rel=1e-5,
                                                     abs=1e-6), k


def _lockstep(jcfg, tcfg, jparams, model, batch, tq=None, jq=None,
              lb_coeff=0.01):
    """``train_loss``'s gradients by blocks in lockstep, for a model whose
    float32 forward drifts over its depth (jamba-smoke's MoE layers carry
    its residual stream at ~50: the port's final hidden states part from
    the reference's by ~2e-4 of their largest value at two chunks, and
    the gradients of the first layers by up to ~7e-4, ten times the
    reference's own jit-against-eager spread). The reference runs its
    forward block by block (``block_apply`` on each unstacked layer) and
    its backward by each block's ``jax.vjp``; the port's embedding, each
    of its blocks and its head are each fed the reference's input and
    output cotangent (a MoE block's lb loss at ``lb_coeff``), and their
    input cotangents and the loss terms are held to the reference's.
    Returns (port gradients, reference gradients), both restacked in the
    reference's layout, and the reference's ``train_loss`` metrics."""
    tok, lab = batch["tokens"], batch["labels"]
    B, S = tok.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    layers = unstack_layers(jparams["segments"], tcfg)
    cd = jcfg.compute_jnp_dtype
    moe = bool(jcfg.num_experts)

    def embed(e):
        x = jcommon.embed_tokens(e, jnp.asarray(tok),
                                 onehot=jcfg.embedding_onehot,
                                 compute_dtype=cd)
        if jq is not None and jq.a_int is not None:
            x = jtr.fake_quant(x, jq.a_int[0], jq.a_frac[0])
        return x

    def head(hp, x):
        h = jcommon.rmsnorm(hp["final_norm"], x, jcfg.norm_eps)
        logits = jcommon.lm_head(
            hp.get("head"), h, tied_table=hp["embed"]["table"]
            if jcfg.tie_embeddings else None)
        return jcommon.cross_entropy(logits, jnp.asarray(lab))

    jitted = {}

    def block(sig):
        """(forward, vjp) of one block signature, jitted once."""
        if sig not in jitted:
            def f(lp, x, q):
                y, _, aux = jtr.block_apply(lp, x, pos, cfg=jcfg, sig=sig,
                                            quant=q)
                return y, aux.get("moe_lb_loss", jnp.zeros((), jnp.float32))

            def back(lp, x, q, gy, glb):
                return jax.vjp(lambda a, b: f(a, b, q), lp, x)[1]((gy, glb))
            jitted[sig] = (jax.jit(f), jax.jit(back))
        return jitted[sig]

    def lq(li):
        return None if jq is None else jq.layer_slice(li)

    x, emb_vjp = jax.vjp(embed, jparams["embed"])
    ins, lbs = [], []
    for li, blk in enumerate(model.layers):
        ins.append(x)
        x, lb = block(blk.sig)[0](layers[li], x, lq(li))
        lbs.append(lb)
    hp = {k: jparams[k] for k in ("final_norm", "head", "embed")
          if k in jparams}
    ce, head_vjp = jax.vjp(head, hp, x)
    g_hp, g = head_vjp(jnp.ones((), jnp.float32))
    n = tcfg.num_layers
    g_out, g_in, g_layers = [None] * n, [None] * n, [None] * n
    for li in reversed(range(n)):
        g_out[li] = g
        g_layers[li], g = block(model.layers[li].sig)[1](
            layers[li], ins[li], lq(li), g,
            jnp.float32(lb_coeff if moe else 0))
        g_in[li] = g
    (g_emb,) = emb_vjp(g)
    lb = sum(lbs)
    jm = jax.jit(lambda p: jtr.train_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        quant=jq))(jparams)[1]
    jloss = jm["loss"]
    # the block chain is the reference's train_loss (its residual's D12
    # grid may put a tie one step apart between the two programs)
    assert float(ce + lb_coeff * lb * moe) == pytest.approx(float(jloss),
                                                            rel=1e-5)

    for p in model.parameters():
        p.grad = None
    xh = t(x).requires_grad_(True)
    h = tcommon.rmsnorm(model.final_norm, xh, tcfg.norm_eps)
    tce = tcommon.cross_entropy(tcommon.lm_head(model.head_weight(), h),
                                t(lab))
    tce.backward()
    assert float(tce.detach()) == pytest.approx(float(ce), rel=1e-5)
    _close(xh.grad, g_out[-1], "head input")
    tlb = 0.0
    for li, blk in enumerate(model.layers):
        kw = {}
        if tq is not None:
            kw = dict(kv_quant=tq.layer_kv(li), w_fmt=tq.layer_weight(li),
                      a_fmt=tq.layer_data(li), state_quant=tq.layer_state(li))
        xi = t(ins[li]).requires_grad_(True)
        y, _, aux = ttr.block_apply(blk, xi, t(pos), cfg=tcfg, cache=None,
                                    cache_pos=None, **kw)
        obj = (y * t(g_out[li])).sum()
        if "moe_lb_loss" in aux:
            obj = obj + lb_coeff * aux["moe_lb_loss"]
            tlb = tlb + float(aux["moe_lb_loss"].detach())
        obj.backward()
        _close(xi.grad, g_in[li], ("block input", li))
    e = model.embed_rows(t(tok))
    if tq is not None and tq.a_int is not None:
        e = fake_quant_ste(e, *tq.layer_data(0))
    (e * t(g)).sum().backward()
    assert tlb == pytest.approx(float(lb), rel=1e-5, abs=1e-7)
    assert float(jm["moe_lb_loss"]) == pytest.approx(float(lb), rel=1e-5,
                                                     abs=1e-7)

    want = {"embed": {"table": np.asarray(g_emb["table"])
                      + (np.asarray(g_hp["embed"]["table"])
                         if jcfg.tie_embeddings else 0.0)},
            "final_norm": g_hp["final_norm"]}
    if "head" in g_hp:
        want["head"] = g_hp["head"]
    segs = {}
    for li, si, j, pp in segment_layers(tcfg):
        segs.setdefault((si, j), {})[pp] = g_layers[li]
    want["segments"] = [[None] * len(pat) for pat in jparams["segments"]]
    for (si, j), per in segs.items():
        want["segments"][si][j] = jax.tree_util.tree_map(
            lambda *a: np.stack(a), *[per[k] for k in range(len(per))])
    return reference_tree(_grads(model), model, tcfg), want, jm


def _close(got, want, label, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (label, err, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(arch):
    """The loss terms (CE, the MoE lb loss, the MTP loss of deepseek-v3,
    qwen2-vl's tied head) within 1e-5 and every gradient leaf within 1e-4
    of its largest magnitude, the recurrent archs at two chunks, jamba's
    gradients by blocks in lockstep (:func:`_lockstep`);
    ``params_to_numpy`` returns the tree that ``params_from_numpy``
    took."""
    jcfg, tcfg, jparams, tree = _arch(arch)
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    batch = _tokens(tcfg.vocab_size, S=_seq(tcfg))
    loss, m = _port_loss(model, tcfg, batch)
    if tcfg.family == "hybrid":
        got, want, jm = _lockstep(jcfg, tcfg, jparams, model, batch)
    else:
        _, jm, jg = _ref_loss(jparams, jcfg, batch)
        got, want = reference_tree(_grads(model), model, tcfg), jg
    _losses_match(m, jm)
    assert (tcfg.mtp_depth > 0) == ("mtp_loss" in m)
    _trees_match(got, want)
    back = _flat(params_to_numpy(model, tcfg))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_cross_entropy_ignores_every_negative_label_and_the_mask():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = np.asarray([[1, -100, 3, -1, 10], [-7, 0, 2, 4, -100]],
                        np.int32)
    mask = np.asarray([[1, 1, 0, 1, 1], [1, 1, 1, 1, 0]], np.int32)
    for mk in (None, mask):
        got = tcommon.cross_entropy(t(logits), t(labels),
                                    None if mk is None else t(mk))
        want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                     None if mk is None else jnp.asarray(mk))
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    none = tcommon.cross_entropy(t(logits), t(np.full((2, 5), -1, np.int32)))
    assert float(none) == 0.0


@pytest.mark.parametrize("chunk", [4, 5, 16])
def test_chunked_ce_loss_matches_reference_and_its_gradient(chunk):
    """Padded to a chunk multiple, each chunk rematerialized: the loss and
    the gradients of hidden and head within 1e-5 of the reference's, and
    equal to the unchunked loss."""
    rng = np.random.default_rng(chunk)
    h = rng.normal(size=(2, 13, 8)).astype(np.float32)
    w = rng.normal(size=(8, 17)).astype(np.float32)
    lab = rng.integers(-1, 17, (2, 13)).astype(np.int32)
    mask = rng.integers(0, 2, (2, 13)).astype(np.int32)
    th, tw = t(h).requires_grad_(), t(w).requires_grad_()
    loss = tcommon.chunked_ce_loss(th, tw, t(lab), chunk=chunk, mask=t(mask))
    loss.backward()
    jl, (jh, jw) = jax.value_and_grad(
        lambda a, b: jcommon.chunked_ce_loss(a, b, jnp.asarray(lab),
                                             chunk=chunk,
                                             mask=jnp.asarray(mask)),
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jh), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), atol=1e-5)
    full = tcommon.cross_entropy(t(h) @ t(w), t(lab), t(mask))
    assert float(loss.detach()) == pytest.approx(float(full), rel=1e-5)


def test_train_loss_with_loss_chunk_matches_reference():
    """A config with ``loss_chunk`` > 0 (none ships with one) takes the
    chunked loss for both the CE and the MTP terms."""
    jcfg, tcfg, jparams, tree = perturbed_jax_params("deepseek-v3-671b",
                                                     jit=True)
    jcfg = dataclasses.replace(jcfg, loss_chunk=6)
    tcfg = dataclasses.replace(tcfg, loss_chunk=6)
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    batch = _tokens(tcfg.vocab_size, S=16)
    loss, m = _port_loss(model, tcfg, batch)
    jloss, jm, jg = _ref_loss(jparams, jcfg, batch)
    for k in m:
        assert float(m[k].detach()) == pytest.approx(float(jm[k]), rel=1e-5)
    _assert_grads_match(model, tcfg, jg)


# ---------------------------------------------------------------------------
# C5: gradients through the fake-quant sites
# ---------------------------------------------------------------------------
def _quants(cfg_t, cfg_j, **bits):
    kw = dict(weight_bits=0, data_bits=0, kv_bits=0, policy_json="")
    kw.update(bits)
    return train_mod.build_quant(cfg_t, **kw), jbuild_quant(cfg_j, **kw)


def _block_matrices(tree):
    """Keys of every >= 2-D leaf of the blocks (stacked: >= 3-D)."""
    return [k for k, v in _flat(tree).items()
            if "segments" in k and v.ndim >= 3]


@pytest.mark.parametrize("bits", [dict(weight_bits=10), dict(data_bits=12)])
def test_c5_reference_quantized_gradients_stop_at_the_blocks(bits):
    """The fault: under W10 or D12 the reference's gradient is exactly
    zero for every block matrix (its ``fake_quant`` rounds with
    ``trunc``, whose derivative is 0); the port's is nonzero for all of
    them."""
    jcfg, tcfg, jparams, tree = perturbed_jax_params("yi-34b", jit=True)
    tq, jq = _quants(tcfg, jcfg, **bits)
    batch = _tokens(tcfg.vocab_size)
    _, _, jg = _ref_loss(jparams, jcfg, batch, quant=jq)
    flat = _flat(jg)
    keys = _block_matrices(jg)
    assert keys and all(not flat[k].any() for k in keys), [
        k for k in keys if flat[k].any()]
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    _port_loss(model, tcfg, batch, quant=tq)
    mine = _flat(reference_tree(_grads(model), model, tcfg))
    assert all(mine[k].any() for k in keys)


@pytest.mark.parametrize("bits", [dict(weight_bits=10), dict(data_bits=12),
                                  dict(weight_bits=10, data_bits=12,
                                       kv_bits=8)])
def test_c5_port_gradients_equal_the_reference_with_ste(bits, monkeypatch):
    """With the reference's ``models.transformer.fake_quant`` replaced by
    its own ``fake_quant_ste`` (by this test, not the package), the
    reference's loss and every gradient leaf equal the port's within the
    stated tolerances."""
    monkeypatch.setattr(jtr, "fake_quant", jfp.fake_quant_ste)
    jcfg, tcfg, jparams, tree = perturbed_jax_params("yi-34b", jit=True)
    tq, jq = _quants(tcfg, jcfg, **bits)
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    batch = _tokens(tcfg.vocab_size)
    loss, _ = _port_loss(model, tcfg, batch, quant=tq)
    jloss, _, jg = _ref_loss(jparams, jcfg, batch, quant=jq)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    _assert_grads_match(model, tcfg, jg)


def test_ste_forward_is_fake_quant_bit_for_bit():
    """Serving values do not move: with and without gradients the
    straight-through site returns ``fake_quant``'s values exactly, and the
    gradient is 1 inside the grid's range, 0 where it clips."""
    from repro_torch.core.fixedpoint import fake_quant, fake_quant_ste
    x = torch.linspace(-9, 9, 301)
    want = fake_quant(x, 4, 8)
    assert torch.equal(fake_quant_ste(x, 4, 8), want)
    xg = x.clone().requires_grad_()
    y = fake_quant_ste(xg, 4, 8)
    assert torch.equal(y.detach(), want)
    y.sum().backward()
    inside = (x * 256 >= -2048) & (x * 256 <= 2047)
    assert torch.equal(xg.grad, inside.to(torch.float32))


# ---------------------------------------------------------------------------
# C8 in a model, training from embeddings
# ---------------------------------------------------------------------------
Q = dict(weight_bits=10, data_bits=12, kv_bits=8)


def _patch_ste(monkeypatch):
    """Both of the reference's fake-quant sites straight-through: the
    weights and the residual (C5) and the recurrent state's grid (C8)."""
    monkeypatch.setattr(jtr, "fake_quant", jfp.fake_quant_ste)
    monkeypatch.setattr(jssm, "_maybe_fake_quant", ref_state_grid_ste)


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-v0.1-52b"])
def test_c8_quantized_recurrent_training_equals_the_reference_with_ste(
        arch, monkeypatch):
    """W10 / D12 / KV8 (the Mamba and mLSTM states on Q2.6 at the chunk
    boundary): with both of the reference's grids straight-through, its
    loss terms and every gradient leaf equal the port's, by blocks in
    lockstep (:func:`_lockstep`: a residual value at a rounding tie of
    the D12 grid lands one step apart in the two packages now and then,
    and the step then travels up the stack)."""
    _patch_ste(monkeypatch)
    jcfg, tcfg, jparams, tree = _arch(arch)
    tq, jq = _quants(tcfg, jcfg, **Q)
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    batch = _tokens(tcfg.vocab_size, S=_seq(tcfg))
    got, want, _ = _lockstep(jcfg, tcfg, jparams, model, batch, tq, jq)
    _trees_match(got, want)


def embeds_batch(cfg, B=2, S=20, seed=0):
    """``configs.shapes.make_batch`` at (B, S) on the CPU, as numpy: a
    stub frontend's embeddings, uniform labels and, for an M-RoPE arch,
    the ids of a square patch grid followed by text positions."""
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=S)
    g = torch.Generator().manual_seed(seed)
    return {k: v.numpy() for k, v in make_batch(
        cfg, shape, generator=g, device="cpu", batch_override=B).items()}


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "w10d12kv8"])
@pytest.mark.parametrize("arch", ["hubert-xlarge", "qwen2-vl-2b"])
def test_train_loss_from_embeddings_matches_reference(arch, quantized,
                                                      monkeypatch):
    """``make_batch`` inputs (hubert: frame embeddings; qwen2-vl: patch
    embeddings with M-RoPE ids) fed to both packages: the loss terms and
    every gradient leaf as from tokens; quantized with both of the
    reference's fake-quant sites straight-through. hubert's untied
    embedding table is never read: the port leaves its gradient None (the
    train step counts it as zeros), the reference's is zeros."""
    if quantized:
        _patch_ste(monkeypatch)
    jcfg, tcfg, jparams, tree = _arch(arch)
    tq, jq = _quants(tcfg, jcfg, **(Q if quantized else {}))
    batch = embeds_batch(tcfg)
    assert "tokens" not in batch
    assert ("mrope_positions" in batch) == (arch == "qwen2-vl-2b")
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    loss, m = _port_loss(model, tcfg, batch, quant=tq)
    jloss, jm, jg = _ref_loss(jparams, jcfg, batch, quant=jq)
    _losses_match(m, jm)
    _assert_grads_match(model, tcfg, jg)
    unused = not tcfg.tie_embeddings
    assert (model.embed.grad is None) == unused
    assert bool(np.asarray(jg["embed"]["table"]).any()) != unused


# ---------------------------------------------------------------------------
# C7: the int8 wire's grouping
# ---------------------------------------------------------------------------
def _normal_grads(model, seed):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(rng.normal(0, 1, p.shape).astype(np.float32))
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("arch", ["yi-34b", "xlstm-350m"])
def test_c7_wire_groups_as_the_reference(arch, monkeypatch):
    """Shared gradients, the reference's tree to its ``compress_gradients``
    and the same values unstacked to the port's: with the train step's
    grouping (one scale per stacked leaf, ``reference_groups``) the
    compressed gradients and the residuals equal the reference's exactly,
    restacked; one scale per unstacked parameter (the grouping before
    the repair) differs on most layer leaves. Then inside
    ``make_train_step``: the gradients of two steps, as the step hands
    them to the wire with its residual, restacked and fed to the
    reference, give the step's own output exactly."""
    jcfg, tcfg, _, tree = _arch(arch)
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    groups = steps_mod.reference_groups(model, tcfg)
    assert groups and all(len(g) > 1 for g in groups)
    ccfg, jccfg = CompressionConfig(), jcompress.CompressionConfig()

    def ref(grads, res):
        stack = lambda v: reference_tree(  # noqa: E731
            {n: x.numpy() for n, x in v.items()}, model, tcfg)
        c, r = jcompress.compress_gradients(
            jax.tree_util.tree_map(jnp.asarray, stack(grads)),
            jax.tree_util.tree_map(jnp.asarray, stack(res)), jccfg)
        return _flat(c), _flat(r)

    def same(got, want):
        got = {k: _flat(reference_tree({n: x.numpy() for n, x in v.items()},
                                       model, tcfg)) for k, v in got.items()}
        return [k for k in want[0] if not (
            np.array_equal(got["c"][k], want[0][k])
            and np.array_equal(got["r"][k], want[1][k]))]

    g = _normal_grads(model, 0)
    r = {n: 0.01 * x for n, x in _normal_grads(model, 1).items()}
    want = ref(g, r)
    c, nr = steps_mod.compress_gradients(g, r, ccfg, groups=groups)
    assert same({"c": c, "r": nr}, want) == []
    c, nr = steps_mod.compress_gradients(g, r, ccfg)
    stacked = [k for k in want[0] if "segments" in k]
    assert len(same({"c": c, "r": nr}, want)) >= len(stacked) // 2

    seen = []
    real = steps_mod.compress_gradients

    def spy(grads, res, cfg, **kw):
        out = real(grads, res, cfg, **kw)
        seen.append(({n: x.clone() for n, x in grads.items()},
                     {n: x.clone() for n, x in res.items()}, out))
        return out

    monkeypatch.setattr(steps_mod, "compress_gradients", spy)
    hp = steps_mod.TrainHParams(lr=1e-3, grad_compress=ccfg)
    state = steps_mod.init_train_state(tcfg, hp, model=model)
    step = steps_mod.make_train_step(tcfg, hp)
    for i in range(2):
        step(state, {k: t(v) for k, v in _tokens(
            tcfg.vocab_size, S=_seq(tcfg), seed=i).items()})
    assert len(seen) == 2
    for grads, res, (c, nr) in seen:
        assert same({"c": c, "r": nr}, ref(grads, res)) == []
