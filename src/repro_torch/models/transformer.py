"""Dense GQA decoder: blocks, the model module, paged caches, forward, and
the converter from the JAX package's parameter tree.

The reference stacks each segment's layers and runs them under
``lax.scan``; here the model is an ``nn.ModuleList`` of one
:class:`DecoderBlock` per layer and the forward is a Python loop, with one
paged pool per layer (the layout of the reference's
``_segment_unrolled``). Other families (MoE, SSM, hybrid, encoder, VLM),
weight/residual fake-quant and the training losses are still to port
(ROADMAP queue A items 2, 4, 11 and 12).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..core.paged_kv import (PagedCacheSpec, PagedKVLayout, init_paged_pool,
                             per_row)
from .attention import GQAttention, KVQuantSpec, gqa_apply, init_gqa
from .common import (dense_init, embed_init, embed_tokens, frozen, lm_head,
                     rmsnorm)
from .mlp import SwiGLU, init_swiglu, swiglu_apply


# ---------------------------------------------------------------------------
# Quantization plumbing
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ModelQuant:
    """Per-layer KV Q(I,F) formats and the uniform storage container.

    ``kv_int``/``kv_frac`` hold one python int per layer (None: float KV
    pages). Built from a PrecisionPolicy by
    ``repro_torch.quant.apply.build_model_quant``."""

    kv_int: Optional[Tuple[int, ...]] = None
    kv_frac: Optional[Tuple[int, ...]] = None
    kv_container: str = "int8"
    kv_scale_mode: str = "static"

    def layer_kv(self, li: int) -> Optional[KVQuantSpec]:
        """Layer ``li``'s KV spec (None: the layer stores float pages)."""
        if self.kv_int is None:
            return None
        return KVQuantSpec(self.kv_int[li], self.kv_frac[li],
                           self.kv_container, scale_mode=self.kv_scale_mode)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------
class DecoderBlock(nn.Module):
    """Pre-norm residual block: x += attn(norm1(x)); x += mlp(norm2(x)).
    Norm scales stay float32 (the reference reads them as float32); the
    projections are stored in the compute dtype."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        D = cfg.d_model
        self.norm1 = frozen(torch.empty(D, dtype=torch.float32,
                                        device=device))
        self.attn = GQAttention(cfg, dtype, device)
        self.norm2 = frozen(torch.empty(D, dtype=torch.float32,
                                        device=device))
        self.mlp = SwiGLU(D, cfg.d_ff, dtype, device)


class Transformer(nn.Module):
    """The dense decoder. ``embed`` is (V, D) and ``head`` (D, V), both in
    the compute dtype; ``head`` is None for tied embeddings."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_dense(cfg)
        self.cfg = cfg
        dt = cfg.torch_dtype
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = frozen(torch.empty(V, D, dtype=dt, device=device))
        self.final_norm = frozen(torch.empty(D, dtype=torch.float32,
                                             device=device))
        self.head = (None if cfg.tie_embeddings else
                     frozen(torch.empty(D, V, dtype=dt, device=device)))
        self.layers = nn.ModuleList(DecoderBlock(cfg, dt, device)
                                    for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head_weight(self) -> torch.Tensor:
        return self.embed.T if self.head is None else self.head


def _check_dense(cfg) -> None:
    if (cfg.family != "dense" or cfg.attention_type != "gqa"
            or cfg.num_experts or any(k != "attn" for k in cfg.layer_kinds)):
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family is ported; MoE, MLA, "
            f"SSM, hybrid, encoder and VLM models are ROADMAP queue A "
            f"item 11")


@torch.no_grad()
def init_model(cfg, *, seed: int = 0, device="cuda") -> Transformer:
    """Random model with the reference's init distributions, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the numbers
    differ from the JAX init's)."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    model.embed.copy_(embed_init(model.embed.shape, torch.float32, g, dev))
    model.final_norm.fill_(1.0)
    if model.head is not None:
        model.head.copy_(dense_init(model.head.shape, torch.float32, g, dev))
    for blk in model.layers:
        blk.norm1.fill_(1.0)
        blk.norm2.fill_(1.0)
        init_gqa(blk.attn, g)
        init_swiglu(blk.mlp, g)
    return model


@torch.no_grad()
def params_from_numpy(tree: Dict[str, Any], cfg, *,
                      device="cuda") -> Transformer:
    """A :class:`Transformer` holding the JAX package's parameters.

    ``tree`` is the reference's ``init_model`` tree with every leaf already
    mapped to numpy (no jax needed here). The reference stacks layers for
    ``lax.scan``: a dense model is one segment with a one-block pattern,
    so every leaf of ``segments[0][0]`` carries a leading layer axis, which
    is unstacked here into one :class:`DecoderBlock` per layer. Weights
    keep their ``(in, out)`` layout and are cast to the compute dtype once
    here, which equals the reference's per-use ``.astype(compute_dtype)``;
    norm scales stay float32."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)

    def put(dst: torch.Tensor, src) -> None:
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {src.shape} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))

    if len(tree["segments"]) != 1 or len(tree["segments"][0]) != 1:
        raise ValueError("a dense model's tree has one segment of one "
                         "block pattern")
    put(model.embed, tree["embed"]["table"])
    put(model.final_norm, tree["final_norm"]["scale"])
    if model.head is not None:
        put(model.head, tree["head"]["kernel"])
    stacked = tree["segments"][0][0]
    mix, ffn = stacked["mixer"], stacked["ffn"]
    attn_names = ["wq", "wk", "wv", "wo"]
    if cfg.attention_bias:
        attn_names += ["bq", "bk", "bv"]
    for li, blk in enumerate(model.layers):
        put(blk.norm1, stacked["norm1"]["scale"][li])
        put(blk.norm2, stacked["norm2"]["scale"][li])
        for n in attn_names:
            put(getattr(blk.attn, n), mix[n][li])
        for n in ("w_gate", "w_up", "w_down"):
            put(getattr(blk.mlp, n), ffn[n][li])
    return model


# ---------------------------------------------------------------------------
# Caches / forward
# ---------------------------------------------------------------------------
def init_cache(cfg, quant: Optional[ModelQuant], paged: PagedCacheSpec,
               device) -> List[Dict[str, torch.Tensor]]:
    """One paged pool per layer (all layers share one page table)."""
    caches = []
    for li in range(cfg.num_layers):
        kvq = quant.layer_kv(li) if quant is not None else None
        layout = PagedKVLayout(
            num_pages=paged.num_pages, page_size=paged.page_size,
            num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
            container="fp" if kvq is None else kvq.container,
            dtype=cfg.torch_dtype)
        caches.append(init_paged_pool(layout, device))
    return caches


def block_apply(blk: DecoderBlock, x, positions, *, cfg, cache, cache_pos,
                kv_quant=None, page_table=None, attn_impl="gather",
                kv_valid_len=None):
    """One pre-norm block. Returns (x, cache)."""
    h = rmsnorm(blk.norm1, x, cfg.norm_eps)
    y, cache = gqa_apply(blk.attn, h, positions, cfg=cfg, cache=cache,
                         cache_pos=cache_pos, kv_quant=kv_quant,
                         page_table=page_table, attn_impl=attn_impl,
                         kv_valid_len=kv_valid_len)
    x = x + y
    h = rmsnorm(blk.norm2, x, cfg.norm_eps)
    return x + swiglu_apply(blk.mlp, h), cache


def forward_hidden(model: Transformer, tokens, cfg, *,
                   quant: Optional[ModelQuant] = None, caches=None,
                   cache_pos=None, page_table=None, attn_impl="gather",
                   kv_valid_len=None):
    """Backbone only: returns (hidden after the final norm, caches).

    tokens: (B, S) ids; ``cache_pos``: scalar or (B,) position of each
    row's first token; ``page_table`` (B, NP) int32 drives the paged
    caches (one pool per layer, updated in place); ``attn_impl``
    ("gather" | "kernel") picks the paged attention route for every chunk
    shape; ``kv_valid_len`` masks padded prefill chunk tails."""
    if caches is None:
        raise NotImplementedError(
            "the cache-free forward (training, whole-prompt prefill) is "
            "ROADMAP queue A item 4")
    x = embed_tokens(model.embed, tokens)
    B, S = x.shape[0], x.shape[1]
    base = per_row(0 if cache_pos is None else cache_pos, B, x.device)
    positions = base[:, None] + torch.arange(S, device=x.device)[None, :]
    for li, blk in enumerate(model.layers):
        kvq = quant.layer_kv(li) if quant is not None else None
        x, caches[li] = block_apply(
            blk, x, positions, cfg=cfg, cache=caches[li],
            cache_pos=cache_pos, kv_quant=kvq, page_table=page_table,
            attn_impl=attn_impl, kv_valid_len=kv_valid_len)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return x, caches


def forward(model: Transformer, tokens, cfg, **kw):
    """Returns (hidden, logits, caches); keywords as
    :func:`forward_hidden`."""
    x, caches = forward_hidden(model, tokens, cfg, **kw)
    return x, lm_head(model.head_weight(), x), caches
