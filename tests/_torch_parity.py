"""Shared helpers for the PyTorch port's parity tests: inputs are made with
numpy seeds and handed to both packages as numpy arrays; JAX stays on the
CPU and runs its Pallas kernels in interpret mode."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.core.fixedpoint import FixedPointFormat as JFormat
from repro.core.fixedpoint import format_params as jformat_params
from repro.core.fixedpoint import fake_quant as jfake_quant
from repro.core.policy import LayerPolicy as JLayer
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.core.qtensor import QuantizedTensor as JQT
from repro.data.synthetic import digits_dataset, shapes32_dataset
from repro.models import cnn as jax_cnn
from repro.models import ssm as jssm
from repro.models import transformer as jtr
from repro.models.transformer import init_model as jax_init_model
from repro.quant.apply import build_model_quant as jbuild
from repro.quant.apply import quantize_param_tree as jquantize
from repro_torch.configs.counting import segment_layers
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.fixedpoint import FixedPointFormat, fake_quant
from repro_torch.core.policy import LayerPolicy, PrecisionPolicy
from repro_torch.core.qtensor import QuantizedTensor
from repro_torch.models import transformer as ttr
from repro_torch.models.cnn import SPECS as CNN_SPECS, cnn_params_from_numpy
from repro_torch.models.transformer import params_from_numpy
from repro_torch.quant.apply import build_model_quant, quantize_param_tree

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

CPU = torch.device("cpu")


def t(x, dtype=None) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor (a private copy)."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def numpy_tree(tree):
    """A JAX parameter tree with every leaf as a numpy array."""
    return jax.tree_util.tree_map(np.asarray, tree)


def perturbed_jax_params(arch: str = "qwen2-72b", seed: int = 0, *,
                         jit: bool = False, over: Optional[dict] = None):
    """(jax config, torch config, jax params, numpy params) for an arch's
    smoke config. The reference initializes biases to 0, norm scales to 1
    and MoE routers at std 0.02 (near-uniform routing); all are redrawn
    here from a numpy seed, in every segment and pattern position (and
    the MTP module), so the parity tests exercise them and the routers
    choose decisively. ``jit`` compiles the reference's init (several
    times faster on the deeper trees; its numbers need not equal the
    eager init's bit for bit). ``over``: fields replaced in both smoke
    configs (``dataclasses.replace``)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), **(over or {}))
    tcfg = dataclasses.replace(get_smoke_config(arch), **(over or {}))
    init = (jax.jit(jax_init_model, static_argnums=1) if jit
            else jax_init_model)
    tree = numpy_tree(init(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)

    def uniform(a):
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    def normal(a, mean=0.0, std=0.5):
        return rng.normal(mean, std, a.shape).astype(np.float32)

    def perturb_block(blk, stacked=True):
        mixer = blk["mixer"]
        for name in ("bq", "bk", "bv"):
            if name in mixer:
                mixer[name] = normal(mixer[name])
        for norm in ("norm1", "norm2"):
            if norm in blk:
                blk[norm]["scale"] = uniform(blk[norm]["scale"])
        for norm in ("q_norm", "kv_norm", "norm"):
            if norm in mixer:
                mixer[norm]["scale"] = uniform(mixer[norm]["scale"])
        # the recurrent mixers' biases and skips (A_log keeps its
        # deterministic linspace init)
        for name in ("conv_b", "dt_bias", "b"):
            if name in mixer:
                mixer[name] = normal(mixer[name])
        # the encoder's GELU MLP biases
        for name in ("b_in", "b_out"):
            if name in blk.get("ffn", {}):
                blk["ffn"][name] = normal(blk["ffn"][name])
        if "D_skip" in mixer:
            mixer["D_skip"] = uniform(mixer["D_skip"])
        if "f_bias" in mixer:
            mixer["f_bias"] = normal(mixer["f_bias"], 2.0, 1.0)
        if "router" in blk.get("ffn", {}):
            r = blk["ffn"]["router"]
            blk["ffn"]["router"] = rng.normal(
                0, 2.0 / np.sqrt(r.shape[-2]), r.shape).astype(np.float32)

    first = True
    for seg in tree["segments"]:
        for blk in seg:
            perturb_block(blk)
            if first:
                tree["final_norm"]["scale"] = uniform(
                    tree["final_norm"]["scale"])
                first = False
    if "mtp" in tree:
        perturb_block(tree["mtp"]["block"])
        tree["mtp"]["norm"]["scale"] = uniform(tree["mtp"]["norm"]["scale"])
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    return jcfg, tcfg, jparams, tree


# ---------------------------------------------------------------------------
# the reference's state grid, straight-through (C8)
# ---------------------------------------------------------------------------
_REF_STATE_GRID = jssm._maybe_fake_quant


@jax.custom_vjp
def _ref_state_ste(x, int_bits, frac_bits):
    return _REF_STATE_GRID(x, (int_bits, frac_bits))


def _ref_state_ste_fwd(x, int_bits, frac_bits):
    scale, qmin, qmax = jformat_params(int_bits, frac_bits)
    s = x.astype(jnp.float32) * scale
    return (_REF_STATE_GRID(x, (int_bits, frac_bits)),
            ((s >= qmin) & (s <= qmax),))


def _ref_state_ste_bwd(res, g):
    (in_range,) = res
    return jnp.where(in_range, g, 0.0).astype(g.dtype), None, None


_ref_state_ste.defvjp(_ref_state_ste_fwd, _ref_state_ste_bwd)


def ref_state_grid_ste(x, quant):
    """The reference's ``ssm._maybe_fake_quant`` with a straight-through
    gradient inside the grid's range (the rule of its own
    ``core.fixedpoint.fake_quant_ste``), for a test to patch in: its
    forward is the reference's own grid."""
    return x if quant is None else _ref_state_ste(x, *quant)


def torch_model(tree, tcfg):
    return params_from_numpy(tree, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# the paper's CNNs
# ---------------------------------------------------------------------------
_cnn_init = jax.jit(jax_cnn.init_cnn, static_argnums=(1,))  # 1 compile a net


@functools.lru_cache(maxsize=None)
def cnn_ref_tree(net: str, seed: int = 0):
    """The reference's ``init_cnn`` for a net, every leaf a numpy array."""
    return numpy_tree(_cnn_init(jax.random.PRNGKey(seed),
                                jax_cnn.SPECS[net]))


def cnn_images(net: str, n: int, seed: int):
    """(n, H, W, C) images and (n,) labels of the net's dataset."""
    make = digits_dataset if net == "lenet" else shapes32_dataset
    return make(n, seed=seed)


def cnn_port(net: str, seed: int = 0):
    """The port's parameters from :func:`cnn_ref_tree`, on the CPU."""
    return cnn_params_from_numpy(cnn_ref_tree(net, seed), CNN_SPECS[net],
                                 "cpu")


def nhwc(x: torch.Tensor) -> np.ndarray:
    """A port activation in the reference's layout."""
    x = x.detach().numpy()
    return x.transpose(0, 2, 3, 1) if x.ndim == 4 else x


def unstack_layers(segments, cfg):
    """The reference's segment-stacked list (``params["segments"]`` or a
    dense ``init_cache``), one entry per layer (``segment_layers``)."""
    out = [None] * cfg.num_layers
    for li, si, j, p in segment_layers(cfg):
        out[li] = jax.tree_util.tree_map(lambda a: a[p], segments[si][j])
    return out


def tie_flips(got, want, scaled, label=""):
    """Integer grids ``got`` (the port's) and ``want`` (the reference's)
    written from float values that differ by float ULPs: they must agree
    except one grid step where the port's value times the grid scale
    (``scaled``, same shape) sits within 1e-3 of a rounding tie. Returns
    the number of such flips."""
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    diff = got - want
    frac = np.asarray(scaled, np.float64) % 1.0
    tie = np.abs(frac - 0.5) < 1e-3
    bad = (np.abs(diff) > 1) | ((diff != 0) & ~tie)
    assert not bad.any(), (label, int(bad.sum()), diff[bad][:8])
    return int((diff != 0).sum())


# ---------------------------------------------------------------------------
# the decoder families: per-layer fake-quant and quantized trees
# ---------------------------------------------------------------------------
def _policy_pair(names, fmts):
    """(port, reference) policies: layer i's weight format fmts[i][0] and
    data format fmts[i][1] ((I, F) or None)."""
    def mk(P, L, F):
        return P(tuple(names), tuple(
            L(None if w is None else F(*w), None if d is None else F(*d))
            for w, d in fmts))
    return (mk(PrecisionPolicy, LayerPolicy, FixedPointFormat),
            mk(JPolicy, JLayer, JFormat))


def _layer_names(cfg):
    return [f"layer_{i:03d}" for i in range(cfg.num_layers)]


def policy_quants(jcfg, tcfg, fmts):
    """(port, reference) weight and residual-stream quant, KV off, from
    per-layer (weight, data) formats as :func:`_policy_pair` takes them."""
    tp, jp = _policy_pair(_layer_names(tcfg), fmts)
    return (build_model_quant(tp, tcfg, quantize_kv=False),
            jbuild(jp, jcfg, quantize_kv=False))


def weight_policies(tcfg, weights):
    """(port, reference) policies with layer i's weight format weights[i]
    ((I, F) or None) and no data formats."""
    return _policy_pair(_layer_names(tcfg), [(w, None) for w in weights])


def quantized_blocks_match(jcfg, tcfg, jparams, model, tq, jq):
    """Weight and residual fake-quant (``tq``/``jq``: the two packages'
    ``build_model_quant``) block by block, each block fed the reference's
    own input, so a value that the two packages' GEMMs (which differ by
    float ULPs) put on opposite sides of a rounding tie moves one grid
    step in that block only, instead of feeding the next. Values agree
    within 1e-4, except, with a residual format, at most 1% of a block's
    values one grid step apart at a tie; each MoE block's lb loss within
    1e-5."""
    for name in ("w_int", "w_frac", "a_int", "a_frac"):
        got, ref = getattr(tq, name), getattr(jq, name)
        assert (got is None) == (ref is None), name
        if got is not None:
            assert list(got) == np.asarray(ref).astype(int).tolist(), name
    B, S = 2, 10
    tok = np.random.default_rng(9).integers(0, tcfg.vocab_size, (B, S))
    x = np.asarray(jparams["embed"]["table"])[tok]
    if tq.layer_data(0) is not None:
        x = np.asarray(jfake_quant(jnp.asarray(x), *tq.layer_data(0)))
        np.testing.assert_array_equal(
            fake_quant(t(x), *tq.layer_data(0)).numpy(), x)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    layers = unstack_layers(jparams["segments"], tcfg)
    jblock = jax.jit(lambda p, x, pos, q, sig: jtr.block_apply(
        p, x, pos, cfg=jcfg, sig=sig, quant=q), static_argnums=4)
    for li, blk in enumerate(model.layers):
        jy, _, jaux = jblock(layers[li], jnp.asarray(x), jnp.asarray(pos),
                             jq.layer_slice(li), blk.sig)
        ty, _, taux = ttr.block_apply(
            blk, t(x), t(pos), cfg=tcfg, cache=None, cache_pos=None,
            w_fmt=tq.layer_weight(li), a_fmt=tq.layer_data(li))
        jy = np.asarray(jy)
        diff = np.abs(ty.numpy() - jy)
        near = diff <= 1e-4 + 1e-4 * np.abs(jy)
        if tq.layer_data(li) is not None:
            # the only other difference allowed: one grid step at a tie
            step = 2.0 ** -tq.layer_data(li)[1]
            flips = ~near & (np.abs(diff - step) <= 1e-4 * np.abs(jy))
            assert flips.mean() <= 0.01, (li, flips.sum())
            near |= flips
        assert near.all(), (li, diff[~near])
        assert set(taux) == set(jaux)
        if taux:
            assert float(taux["moe_lb_loss"]) == pytest.approx(
                float(jaux["moe_lb_loss"]), rel=1e-5)
        x = jy


def quantized_tree_matches(jcfg, tcfg, jparams, model, tp, jp):
    """``quantize_param_tree`` under the port's policy ``tp`` against the
    reference's under ``jp``, one grid a layer: each segment's format is
    the max over its own layers; every leaf, grid or passed-through
    tensor, byte for byte and of the reference slice's shape; the MTP
    module passes through. Returns the (int, frac, packed) formats seen."""
    got = quantize_param_tree(model, tp)
    want = jax.jit(jquantize, static_argnums=(1, 2))(jparams, jp, jcfg)
    np.testing.assert_array_equal(got["embed"]["table"].numpy(),
                                  np.asarray(want["embed"]["table"]))
    formats = set()
    for li, si, j, p in segment_layers(tcfg):
        flat_t = jax.tree_util.tree_flatten_with_path(
            got["layers"][li], is_leaf=lambda a: isinstance(
                a, QuantizedTensor))[0]
        flat_j = dict(jax.tree_util.tree_flatten_with_path(
            want["segments"][si][j],
            is_leaf=lambda a: isinstance(a, JQT))[0])
        assert len(flat_t) == len(flat_j)
        for path, leaf in flat_t:
            refl = flat_j[path]
            if isinstance(refl, JQT):
                assert isinstance(leaf, QuantizedTensor), path
                fmt = (leaf.int_bits, leaf.frac_bits, leaf.packed)
                assert fmt == (refl.int_bits, refl.frac_bits,
                               refl.packed), path
                assert leaf.shape == tuple(refl.shape[1:]), path
                formats.add(fmt)
                np.testing.assert_array_equal(leaf.data.numpy(),
                                              np.asarray(refl.data[p]))
            else:
                np.testing.assert_array_equal(leaf.numpy(),
                                              np.asarray(refl[p]))
    if "mtp" in want:
        np.testing.assert_array_equal(got["mtp"]["proj"].numpy(),
                                      np.asarray(want["mtp"]["proj"]))
    return formats
