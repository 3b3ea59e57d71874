"""The port's training path against the reference's single-device
functions: ``train_loss`` (losses and every gradient leaf) on four smoke
archs, the losses' helpers, C5 (the reference's quantized training passes
no gradient to the weights; the port's straight-through fake-quant
equals the reference with ``fake_quant`` replaced by ``fake_quant_ste``),
the trainable model's cast at use. The train step and the CLI are in
``test_torch_train_step.py``.

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
from _torch_parity import perturbed_jax_params, t  # noqa: E402

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.launch.train import build_quant as jbuild_quant  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer import (params_from_numpy,  # noqa
                                            params_to_numpy,
                                            reference_tree)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ARCHS = ["qwen2-72b", "llama4-maverick-400b-a17b", "deepseek-v3-671b",
         "qwen2-vl-2b"]


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


def _assert_grads_match(model, tcfg, jgrads, tol=1e-4):
    """Every gradient leaf, restacked into the reference's layout, within
    ``tol`` of the leaf's largest magnitude."""
    got = _flat(reference_tree(_grads(model), model, tcfg))
    want = _flat(jgrads)
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * scale, (k, err, scale)


def _port_loss(model, tcfg, tok, lab, quant=None):
    for p in model.parameters():
        p.grad = None
    loss, m = ttr.train_loss(model, {"tokens": t(tok), "labels": t(lab)},
                             tcfg, quant=quant)
    loss.backward()
    return loss, m


def _ref_loss(jparams, jcfg, tok, lab, quant=None):
    fn = jax.jit(jax.value_and_grad(lambda p: jtr.train_loss(
        p, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}, jcfg,
        quant=quant), has_aux=True))
    (loss, m), g = fn(jparams)
    return loss, m, g


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_reference(arch):
    """The loss terms (CE, the MoE lb loss, the MTP loss of deepseek-v3,
    qwen2-vl's tied head) within 1e-5 and every gradient leaf within 1e-4
    of its largest magnitude; ``params_to_numpy`` returns the tree that
    ``params_from_numpy`` took."""
    jcfg, tcfg, jparams, tree = perturbed_jax_params(arch, jit=True)
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    tok, lab = _batch(tcfg.vocab_size)
    loss, m = _port_loss(model, tcfg, tok, lab)
    jloss, jm, jg = _ref_loss(jparams, jcfg, tok, lab)
    assert set(m) == set(jm)
    for k in m:
        assert float(m[k].detach()) == pytest.approx(float(jm[k]), rel=1e-5,
                                                     abs=1e-6)
    assert (tcfg.mtp_depth > 0) == ("mtp_loss" in m)
    _assert_grads_match(model, tcfg, jg)
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
    tok, lab = _batch(tcfg.vocab_size, S=16)
    loss, m = _port_loss(model, tcfg, tok, lab)
    jloss, jm, jg = _ref_loss(jparams, jcfg, tok, lab)
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
    tok, lab = _batch(tcfg.vocab_size)
    _, _, jg = _ref_loss(jparams, jcfg, tok, lab, quant=jq)
    flat = _flat(jg)
    keys = _block_matrices(jg)
    assert keys and all(not flat[k].any() for k in keys), [
        k for k in keys if flat[k].any()]
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    _port_loss(model, tcfg, tok, lab, quant=tq)
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
    tok, lab = _batch(tcfg.vocab_size)
    loss, _ = _port_loss(model, tcfg, tok, lab, quant=tq)
    jloss, _, jg = _ref_loss(jparams, jcfg, tok, lab, quant=jq)
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
