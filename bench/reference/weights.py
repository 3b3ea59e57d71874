"""The benchmark's weights, made from ``--seed`` on the device.

Both sides take their weights from here: the harness copies them into
the program's model, and the reference draws the same numbers again, one
layer at a time, so it never reads anything the program holds. Each
layer is one draw of a flat buffer from a ``torch.Generator`` seeded by
(seed, layer), cut into its matrices and scaled to a fan-in normal; the
embedding and the head are a draw each. Norm scales are ones. The
distributions are the benchmark's own (listed under ``assumed`` in each
configuration file), not a published checkpoint's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Tuple

import torch

EMBED_STD = 0.02      # the embedding table's normal std
BIAS_STD = 0.02       # the QKV biases' normal std


@dataclasses.dataclass(frozen=True)
class Dims:
    """The widths and depth of a dense GQA decoder, as run."""

    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool
    rope_theta: float
    norm_eps: float

    @classmethod
    def from_config(cls, c: dict) -> "Dims":
        """From a configuration file's keys (the Hugging Face names)."""
        d, h = int(c["hidden_size"]), int(c["num_attention_heads"])
        return cls(layers=int(c["num_hidden_layers"]), d_model=d, heads=h,
                   kv_heads=int(c["num_key_value_heads"]),
                   head_dim=int(c.get("head_dim", d // h)),
                   d_ff=int(c["intermediate_size"]),
                   vocab=int(c["vocab_size"]),
                   qkv_bias=bool(c.get("qkv_bias", False)),
                   rope_theta=float(c["rope_theta"]),
                   norm_eps=float(c["rms_norm_eps"]))


def layer_leaves(dims: Dims) -> List[Tuple[str, tuple, float]]:
    """(name, shape, std) of one layer's drawn leaves, in draw order;
    matrices in the (in, out) layout."""
    D, F = dims.d_model, dims.d_ff
    hq, hk = dims.heads * dims.head_dim, dims.kv_heads * dims.head_dim
    out = [("wq", (D, hq), D ** -0.5), ("wk", (D, hk), D ** -0.5),
           ("wv", (D, hk), D ** -0.5), ("wo", (hq, D), hq ** -0.5),
           ("w_gate", (D, F), D ** -0.5), ("w_up", (D, F), D ** -0.5),
           ("w_down", (F, D), F ** -0.5)]
    if dims.qkv_bias:
        out += [("bq", (hq,), BIAS_STD), ("bk", (hk,), BIAS_STD),
                ("bv", (hk,), BIAS_STD)]
    return out


def leaf_seed(seed: int, tag: str) -> int:
    """A generator seed for one draw: a hash of (seed, tag) in [0, 2^63)."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _generator(device, seed: int, tag: str) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, tag))
    return g


def make_layer(dims: Dims, seed: int, li: int, dtype,
               device) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s leaves (name -> tensor, views of one buffer drawn
    in ``dtype`` on ``device``), plus ``norm1`` and ``norm2`` (float32
    ones)."""
    leaves = layer_leaves(dims)
    total = sum(math.prod(s) for _, s, _ in leaves)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=_generator(device, seed, f"layer{li}"))
    out, off = {}, 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape).mul_(std)
        off += n
    ones = torch.ones(dims.d_model, dtype=torch.float32, device=device)
    out["norm1"], out["norm2"] = ones, ones.clone()
    return out


def make_embed(dims: Dims, seed: int, dtype, device) -> torch.Tensor:
    """The (vocab, d_model) embedding table."""
    t = torch.empty((dims.vocab, dims.d_model), dtype=dtype, device=device)
    return t.normal_(generator=_generator(device, seed, "embed")).mul_(
        EMBED_STD)


def make_head(dims: Dims, seed: int, dtype, device) -> torch.Tensor:
    """The (d_model, vocab) output head (untied)."""
    t = torch.empty((dims.d_model, dims.vocab), dtype=dtype, device=device)
    return t.normal_(generator=_generator(device, seed, "head")).mul_(
        dims.d_model ** -0.5)
