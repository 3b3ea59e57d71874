"""The harness's side of the program: a configuration file turned into the
port's ``ModelConfig``, and the benchmark's weights copied into the
port's model. Only the drivers import this; the reference never does."""
from __future__ import annotations

import torch

from .reference.weights import Dims, make_embed, make_head, make_layer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(config: dict):
    """The port's ``ModelConfig`` of a configuration file (its Hugging
    Face keys, as run)."""
    from repro_torch.configs.base import ModelConfig
    d = Dims.from_config(config)
    return ModelConfig(
        name=config["name"], family="dense", num_layers=d.layers,
        d_model=d.d_model, num_heads=d.heads, num_kv_heads=d.kv_heads,
        d_ff=d.d_ff, vocab_size=d.vocab, head_dim=d.head_dim,
        attention_bias=d.qkv_bias, rope_theta=d.rope_theta,
        norm_eps=d.norm_eps, dtype=config["torch_dtype"],
        param_dtype="float32")


@torch.no_grad()
def build_model(config: dict, seed: int, device, *, trainable: bool = False):
    """The port's ``Transformer`` holding the benchmark's weights of
    ``seed``: the served dtype (``torch_dtype``), or float32 masters when
    ``trainable``. Drawn a layer at a time on ``device``."""
    from repro_torch.models.transformer import Transformer
    cfg = model_config(config)
    dims = Dims.from_config(config)
    dev = torch.device(device)
    dt = torch.float32 if trainable else _DTYPES[config["torch_dtype"]]
    model = Transformer(cfg, device=dev, trainable=trainable)
    for li, blk in enumerate(model.layers):
        w = make_layer(dims, seed, li, dt, dev)
        for name in ("wq", "wk", "wv", "wo") + (
                ("bq", "bk", "bv") if dims.qkv_bias else ()):
            getattr(blk.attn, name).copy_(w[name])
        for name in ("w_gate", "w_up", "w_down"):
            getattr(blk.mlp, name).copy_(w[name])
        blk.norm1.copy_(w["norm1"])
        blk.norm2.copy_(w["norm2"])
        del w
    model.embed.copy_(make_embed(dims, seed, dt, dev))
    model.head.copy_(make_head(dims, seed, dt, dev))
    model.final_norm.fill_(1.0)
    return cfg, model


def served_dtype(config: dict):
    return _DTYPES[config["torch_dtype"]]
