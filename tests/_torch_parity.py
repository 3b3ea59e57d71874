"""Shared helpers for the PyTorch port's parity tests: inputs are made with
numpy seeds and handed to both packages as numpy arrays; JAX stays on the
CPU and runs its Pallas kernels in interpret mode."""
from __future__ import annotations

import jax
import numpy as np
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.transformer import init_model as jax_init_model
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models.transformer import params_from_numpy

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


def perturbed_jax_params(arch: str = "qwen2-72b", seed: int = 0):
    """(jax config, torch config, jax params, numpy params) for an arch's
    smoke config. The reference initializes biases to 0 and norm scales to
    1; both are redrawn here from a numpy seed so the parity tests exercise
    them."""
    jcfg = jax_smoke_config(arch)
    tcfg = get_smoke_config(arch)
    tree = numpy_tree(jax_init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed + 1)
    seg = tree["segments"][0][0]
    for name in ("bq", "bk", "bv"):
        if name in seg["mixer"]:
            seg["mixer"][name] = rng.normal(
                0, 0.5, seg["mixer"][name].shape).astype(np.float32)
    for norm in ("norm1", "norm2"):
        seg[norm]["scale"] = rng.uniform(
            0.5, 1.5, seg[norm]["scale"].shape).astype(np.float32)
    tree["final_norm"]["scale"] = rng.uniform(
        0.5, 1.5, tree["final_norm"]["scale"].shape).astype(np.float32)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    return jcfg, tcfg, jparams, tree


def torch_model(tree, tcfg):
    return params_from_numpy(tree, tcfg, device="cpu")
