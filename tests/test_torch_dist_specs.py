"""The training placements of the port (``parallel.sharding``:
``param_specs(inference=False)``, ``state_specs`` / ``state_shardings``,
``auto_batch_specs`` / ``auto_batch_sharding``, ``cache_specs`` /
``cache_shardings``) against the reference's PartitionSpecs of the same
leaves, on ``AbstractMesh``es (2, 2), (2, 4), (4, 2), (16, 16) and
(2, 16, 16), for every arch's smoke and published config, float32 and
int8 moments, with and without the wire's residuals.

A layer leaf is matched through ``reference_layout`` (its reference path
and stacked shape) and its period axis dropped. One exception, by design
and by name (``EXCEPTION``): a per-layer 1-D leaf (the norm scales, MLA's
``q_norm`` / ``kv_norm``, the xLSTM mixers' ``b``, ``f_bias`` and
``norm``, Mamba's ``A_log``, ``D_skip``, ``conv_b``, ``dt_bias`` and
``norm``) is 2-D stacked, takes the generic 2-D rule and has its PERIOD
axis over "data" in the reference; the port replicates it over "data"
and keeps the rest of the reference's spec."""
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs.registry import ARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke_config as jsmoke
from repro.launch.steps import TrainHParams as JHParams
from repro.launch.steps import init_train_state as jinit_state
from repro.models.transformer import init_cache as jinit_cache
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.compress import CompressionConfig as JCompress
from repro.parallel import sharding as jsharding
from repro_torch.configs.counting import segment_layers
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.launch.steps import _meta_state
from repro_torch.models.transformer import (Transformer, init_cache,
                                            reference_layout)
from repro_torch.parallel.sharding import (AbstractMesh, auto_batch_sharding,
                                           auto_batch_specs, cache_shardings,
                                           cache_specs, param_shardings,
                                           param_specs, plan_for_mesh,
                                           state_shardings, state_specs)

MESHES = [((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# the port's per-layer leaves whose stacked reference leaf shards its
# period axis (a 1-D leaf a layer under the generic 2-D rule)
EXCEPTION = re.compile(
    r"^layers\.\d+\.(norm1|norm2|attn\.(q|kv)_norm"
    r"|mixer\.(b|f_bias|norm|A_log|D_skip|conv_b|dt_bias))$")


def _plans(shape, axes):
    return (jsharding.plan_for_mesh(JAbstractMesh(shape, axes)),
            plan_for_mesh(AbstractMesh(shape, axes)))


def _spec(sharding, ndim):
    spec = tuple(sharding.spec)
    return spec + (None,) * (ndim - len(spec))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _configs(arch, which):
    if which == "smoke":
        return jsmoke(arch), get_smoke_config(arch)
    return jget_config(arch), get_config(arch)


def _check(got, ref, shapes, path, period, name, excepted):
    """The port's ``got`` against the reference's spec of the leaf at
    ``path`` (its period axis dropped for a layer leaf)."""
    want = _spec(_leaf(ref, path), len(_leaf(shapes, path).shape))
    if period is not None:
        if want[0] is not None:
            excepted.add(name)
        want = want[1:]
    assert got == want, (name, path, got, want)


@pytest.mark.parametrize("which", ["smoke", "published"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_equal_the_references(arch, which):
    """Every leaf of the train state (parameters, float32 moments, int8
    moments' q and scale, residuals, the step) on the five meshes."""
    jcfg, tcfg = _configs(arch, which)
    model = Transformer(tcfg, device="meta", trainable=True)
    layout = reference_layout(model, tcfg)
    excepted = set()
    sharded = 0
    for int8 in (False, True):
        jhp = JHParams(adamw=JAdamW(quantize_moments=int8),
                       grad_compress=JCompress() if int8 else None)
        shapes = jax.eval_shape(lambda k: jinit_state(k, jcfg, jhp),
                                jax.random.PRNGKey(0))
        state = _meta_state(tcfg, int8=int8, residual=int8)
        for shape, axes in MESHES:
            jplan, plan = _plans(shape, axes)
            ref = jsharding.state_shardings(shapes, jplan)
            got = state_specs(state, tcfg, plan)
            placed = state_shardings(state, tcfg, plan)
            assert got["opt"]["step"] == () == _spec(ref["opt"]["step"], 0)
            for name, path, period in layout:
                _check(got["params"][name], ref["params"],
                       shapes["params"], path, period, name, excepted)
                sharded += any(a is not None for a in got["params"][name])
                for k in ("m", "v"):
                    mine = got["opt"][k][name]
                    if int8:
                        for part in ("q", "scale"):
                            _check(mine[part], ref["opt"][k],
                                   shapes["opt"][k], path + (part,), period,
                                   name, excepted)
                    else:
                        _check(mine, ref["opt"][k], shapes["opt"][k], path,
                               period, name, excepted)
                if int8:
                    _check(got["ef_residual"][name], ref["ef_residual"],
                           shapes["ef_residual"], path, period, name,
                           excepted)
                assert len(placed["params"][name]) == len(shape)
    assert sharded > 0
    assert all(EXCEPTION.match(n) for n in excepted), sorted(excepted)
    params = dict(model.named_parameters())
    assert all(params[n].dim() == 1 for n in excepted)


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v[0], int) else None)
def test_training_param_specs_equal_the_references(shape, axes):
    """``param_specs(inference=False)`` on every smoke config: the
    reference's ``param_shardings`` of the same leaf, the period axis
    dropped, the per-layer 1-D leaves replicated over
    "data" as the one exception (``EXCEPTION``)."""
    jplan, plan = _plans(shape, axes)
    for arch in ARCH_IDS:
        jcfg, tcfg = _configs(arch, "smoke")
        model = Transformer(tcfg, device="meta")
        shapes = jax.eval_shape(lambda: __import__(
            "repro.models.transformer", fromlist=["init_model"]).init_model(
            jax.random.PRNGKey(0), jcfg))
        ref = jsharding.param_shardings(shapes, jplan)
        got = param_specs(model, tcfg, plan)
        placed = param_shardings(model, tcfg, plan)
        excepted = set()
        for name, path, period in reference_layout(model, tcfg):
            _check(got[name], ref, shapes, path, period, name, excepted)
            assert len(placed[name]) == len(shape)
        assert all(EXCEPTION.match(n) for n in excepted), (arch, excepted)
        if shape == (2, 2) and arch == "yi-34b":
            assert {n.split(".", 2)[-1] for n in excepted} == {"norm1",
                                                               "norm2"}


def _batches(B, S=8, D=16):
    rng = np.random.default_rng(B)
    return {"tokens": rng.integers(0, 100, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 100, (B, S)).astype(np.int32),
            "mask": np.ones((B, S), np.int32),
            "embeds": rng.normal(size=(B, S, D)).astype(np.float32),
            "positions": np.zeros((B, S), np.int32),
            "mrope_positions": np.zeros((B, S, 3), np.int32),
            "step": np.zeros((), np.int32)}


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v[0], int) else None)
def test_batch_specs_equal_the_references(shape, axes):
    """Dim 0 over ("pod", "data") when it divides, else "data" alone, else
    "pod", else replicated; scalars replicated; at batch sizes that
    divide everything, only "data" or "pod", and nothing."""
    jplan, plan = _plans(shape, axes)
    for B in (64, 32, 16, 6, 4, 3, 2, 1):
        batch = _batches(B)
        ref = jsharding.auto_batch_sharding(
            {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in batch.items()}, jplan)
        got = auto_batch_specs(batch, plan)
        placed = auto_batch_sharding(batch, plan)
        for k, v in batch.items():
            assert got[k] == _spec(ref[k], v.ndim), (B, k, got[k])
            assert len(placed[k]) == len(shape)
            if got[k] and got[k][0] is not None:
                axes0 = got[k][0] if isinstance(got[k][0], tuple) \
                    else (got[k][0],)
                for ax, pl in zip(axes, placed[k]):
                    assert pl.is_shard(0) == (ax in axes0)


@pytest.mark.parametrize("kv_bits", [0, 8])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_the_references(arch, kv_bits):
    """Dense caches (KV slabs, MLA latents, recurrent states; float and
    int8 with scales): each layer's leaves against the reference's
    ``cache_shardings`` of its stacked leaf (``lead`` = 1), the period
    axis dropped, on the five meshes at batch 8 and max_len 32."""
    from repro.core.fixedpoint import FixedPointFormat as JFmt
    from repro.core.policy import PrecisionPolicy as JPolicy
    from repro.quant.apply import build_model_quant as jbuild
    from repro.quant.apply import transformer_layer_names as jnames
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.quant.apply import (build_model_quant,
                                         transformer_layer_names)
    jcfg, tcfg = _configs(arch, "smoke")
    jq = tq = None
    if kv_bits:
        jq = jbuild(JPolicy.uniform(jnames(jcfg), None, JFmt(2, 6)), jcfg,
                    quantize_kv=True, quantize_activations=False)
        tq = build_model_quant(PrecisionPolicy.uniform(
            transformer_layer_names(tcfg), None, FixedPointFormat(2, 6)),
            tcfg, quantize_kv=True, quantize_activations=False)
    B, T = 8, 32
    shapes = jax.eval_shape(lambda: jinit_cache(jcfg, B, T, jq))
    caches = init_cache(tcfg, tq, None, "meta", batch=B, max_len=T)
    where = {li: (si, j) for li, si, j, _ in segment_layers(tcfg)}
    for shape, axes in MESHES:
        jplan, plan = _plans(shape, axes)
        ref = jsharding.cache_shardings(shapes, jplan)
        got = cache_specs(caches, plan)
        placed = cache_shardings(caches, plan)
        for li, layer in enumerate(got):
            si, j = where[li]
            assert set(layer) == set(ref[si][j]), (li, set(layer))
            for key, spec in layer.items():
                want = _spec(ref[si][j][key], shapes[si][j][key].ndim)
                assert spec == want[1:], (arch, li, key, spec, want)
                assert len(placed[li][key]) == len(shape)


def test_placements_of_a_batch_dim_over_two_axes():
    """("pod", "data") on dim 0 is Shard(0) on both axes, pod major."""
    plan = plan_for_mesh(AbstractMesh((2, 2, 4), ("pod", "data", "model")))
    placed = auto_batch_sharding({"tokens": torch.zeros(8, 3)}, plan)
    pod, data, model = placed["tokens"]
    assert pod.is_shard(0) and data.is_shard(0) and model.is_replicate()
