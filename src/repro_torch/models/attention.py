"""GQA attention (with optional QKV bias) over the paged quantized KV pool.

* ``gqa_apply`` — the paged branch of the reference's ``gqa_apply``: QKV
  projections + bias, RoPE, the pool write, attention, output projection.
* ``paged_cache_update`` — the pool write (quantize, pack, scatter).
* ``route_paged_attention`` — ONE entry point for every paged attention
  read, chunked prefill (S > 1) and decode (S == 1) alike:
  ``attn_impl="kernel"`` sends it through the CUDA kernel of
  ``kernels.paged_kv_attention`` (its plain version on CPU tensors),
  ``"gather"`` reads the pool through the dense gather and
  ``attend_chunked``'s online softmax.

The dense-cache and cache-free (training) branches, M-RoPE and MLA are
still to port (ROADMAP queue A items 4 and 11).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core.paged_kv import paged_gather, paged_update, per_row, \
    pool_container
from ..kernels.paged_kv_attention import (paged_kv_attention_chunk,
                                          paged_kv_attention_decode)
from .common import apply_rope, dense_init, frozen

NEG_INF = -1e30
ATTN_IMPLS = ("gather", "kernel")


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """One layer's fixed-point KV format (the paper's data bits) and its
    storage container."""

    int_bits: int
    frac_bits: int
    container: str = "int8"
    scale_mode: str = "static"


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------
def paged_cache_update(cache, k_new, v_new, page_table, pos,
                       quant: Optional[KVQuantSpec] = None, valid_len=None):
    """Append S new tokens through the page table (pos scalar or (B,));
    ``valid_len`` sends padded chunk tails to the scratch page. Updates
    ``cache`` in place and returns it."""
    return paged_update(
        cache, k_new, v_new, page_table, pos,
        page_size=cache["k_pages"].shape[1], container=pool_container(cache),
        int_bits=None if quant is None else quant.int_bits,
        frac_bits=None if quant is None else quant.frac_bits,
        valid_len=valid_len,
        scale_mode="static" if quant is None else quant.scale_mode)


def paged_cache_view(cache, page_table, *, head_dim, dtype):
    """Logical dense (B, NP*ps, KV, hd) float view of a paged cache."""
    return paged_gather(cache, page_table, container=pool_container(cache),
                        head_dim=head_dim, dtype=dtype)


def route_paged_attention(q, cache, page_table, positions, cache_pos, *,
                          cfg, attn_impl: str = "gather",
                          operand_dtype=torch.float32):
    """Variable-length paged attention for a chunk of S queries per row.

    ``q``: (B, S, H, hd) post-RoPE queries; ``cache``: the pool AFTER this
    chunk's write; ``cache_pos``: scalar or (B,) position of the chunk's
    first token. The kernel route passes the reference's arguments: S == 1
    goes to the decode entry with ``kv_len = base + 1``; S > 1 to the chunk
    entry with ``q_start = base`` and ``kv_len = base + S``, padded chunks
    included (every real query's causal bound excludes the padded keys).
    Non-causal configs stay on the gather route. Returns (B, S, H, hd) in
    q.dtype."""
    B, S, H, hd = q.shape
    base = per_row(cache_pos, B, q.device)
    if attn_impl == "kernel" and cfg.causal:
        bits = {"int8": 8, "int4": 4, "fp": 0}[pool_container(cache)]
        args = (cache["k_pages"], cache["v_pages"], cache["k_scale"],
                cache["v_scale"], page_table)
        if S == 1:
            out = paged_kv_attention_decode(q[:, 0], *args, base + 1,
                                            bits=bits)
            return out.reshape(B, 1, H, hd).to(q.dtype)
        out = paged_kv_attention_chunk(q, *args, base, base + S, bits=bits)
        return out.to(q.dtype)
    kd, vd = paged_cache_view(cache, page_table, head_dim=hd,
                              dtype=operand_dtype)
    return attend_chunked(q, kd, vd, positions, 0, causal=cfg.causal,
                          kv_len=base + S, chunk=cfg.attn_chunk,
                          operand_dtype=operand_dtype)


# ---------------------------------------------------------------------------
# Online-softmax attention over KV chunks (the gather route)
# ---------------------------------------------------------------------------
def _len_col(kv_len, ndim: int, device) -> torch.Tensor:
    """kv_len (scalar or (B,)) -> (B|1, 1, ..) column masking a trailing
    KV-position axis."""
    return torch.as_tensor(kv_len, device=device).reshape(
        (-1,) + (1,) * (ndim - 1))


def attend_chunked(q, k, v, q_pos, kv_start, *, causal=True, kv_len=None,
                   chunk=1024, scale=None, operand_dtype=torch.float32):
    """Flash-style online-softmax attention, scanning KV in ``chunk``s.

    q: (B, S, H, hd); k/v: (B, T, KV, hd) float; q_pos: (B, S) absolute
    query positions. S == 1 runs grouped (B, KV, G) math and never expands
    K/V across the group; S > 1 works in expanded H-head space, as the
    reference does. Softmax state and products are float32."""
    B, S, H, hd = q.shape
    KV, T = k.shape[2], k.shape[1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / np.sqrt(hd)
    chunk = min(chunk, T)
    if T % chunk:
        pad = chunk - T % chunk
        k = nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        T = T + pad
        if kv_len is None:
            kv_len = T - pad
    nc = T // chunk
    if S == 1:
        return _attend_chunked_grouped(q, k, v, q_pos, kv_start,
                                       causal=causal, kv_len=kv_len,
                                       chunk=chunk, scale=scale, nc=nc)
    dev = q.device
    qh = (q.to(torch.float32) * scale).to(operand_dtype)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, H, v.shape[-1]), dtype=torch.float32,
                      device=dev)
    for idx in range(nc):
        kc = k[:, idx * chunk:(idx + 1) * chunk].to(operand_dtype)
        vc = v[:, idx * chunk:(idx + 1) * chunk].to(operand_dtype)
        if G > 1:
            kc = torch.repeat_interleave(kc, G, dim=2)
            vc = torch.repeat_interleave(vc, G, dim=2)
        s = torch.einsum("bshd,bthd->bhst", qh.to(torch.float32),
                         kc.to(torch.float32))
        pos = kv_start + idx * chunk + torch.arange(chunk, device=dev)
        valid = torch.ones((B, S, chunk), dtype=torch.bool, device=dev)
        if causal:
            valid = valid & (pos[None, None, :] <= q_pos[:, :, None])
        if kv_len is not None:
            valid = valid & (pos[None, None, :] < _len_col(kv_len, 3, dev))
        s = torch.where(valid[:, None, :, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhst,bthd->bshd", p, vc.to(torch.float32))
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l.transpose(1, 2)[..., None], min=1e-30)
    return out.to(q.dtype)


def _attend_chunked_grouped(q, k, v, q_pos, kv_start, *, causal, kv_len,
                            chunk, scale, nc):
    """Online-softmax decode attention in grouped (B, KV, G) layout; S is 1.
    (Like the reference, the causal bound is always applied here.)"""
    B, S, H, hd = q.shape
    KV, vd = k.shape[2], v.shape[-1]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, KV, G, hd).to(torch.float32) * scale
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, vd), dtype=torch.float32, device=dev)
    for idx in range(nc):
        kc = k[:, idx * chunk:(idx + 1) * chunk].to(torch.float32)
        vc = v[:, idx * chunk:(idx + 1) * chunk].to(torch.float32)
        s = torch.einsum("bkgh,btkh->bkgt", qg, kc)
        pos = kv_start + idx * chunk + torch.arange(chunk, device=dev)
        valid = pos[None, :] <= q_pos[:, -1:]
        if kv_len is not None:
            valid = valid & (pos[None, :] < _len_col(kv_len, 2, dev))
        s = torch.where(valid[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgt,btkh->bkgh", p, vc)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, 1, H, vd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------
class GQAttention(nn.Module):
    """Projection weights in the reference's ``(in, out)`` layout, stored
    in the compute dtype; allocated uninitialized (see :func:`init_gqa`)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        mk = lambda *shape: frozen(torch.empty(shape, dtype=dtype,
                                               device=device))
        self.wq = mk(D, H * hd)
        self.wk = mk(D, KV * hd)
        self.wv = mk(D, KV * hd)
        self.wo = mk(H * hd, D)
        self.has_bias = cfg.attention_bias
        if self.has_bias:
            self.bq = mk(H * hd)
            self.bk = mk(KV * hd)
            self.bv = mk(KV * hd)


def init_gqa(p: GQAttention, generator: torch.Generator) -> None:
    """The reference's init distributions (fan-in truncated normal; zero
    biases), drawn from ``generator``."""
    dev = p.wq.device
    for w in (p.wq, p.wk, p.wv):
        w.copy_(dense_init(w.shape, torch.float32, generator, dev))
    p.wo.copy_(dense_init(p.wo.shape, torch.float32, generator, dev,
                          scale=1.0 / np.sqrt(p.wo.shape[0])))
    if p.has_bias:
        for b in (p.bq, p.bk, p.bv):
            b.zero_()


def gqa_apply(p: GQAttention, x, positions, *, cfg, cache=None,
              cache_pos=None, kv_quant: Optional[KVQuantSpec] = None,
              page_table=None, attn_impl: str = "gather",
              kv_valid_len=None):
    """Returns (y, cache). ``positions``: (B, S) absolute positions;
    ``cache``: this layer's paged pool (updated in place); ``page_table``:
    (B, NP) int32; ``attn_impl``: "gather" | "kernel" (see
    :func:`route_paged_attention`); ``kv_valid_len`` (scalar or (B,)) marks
    only the first tokens of a padded prefill chunk as real."""
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cache is None or "k_pages" not in cache:
        raise NotImplementedError(
            "only the paged-cache attention path is ported; dense caches "
            "and cache-free attention are ROADMAP queue A item 4")
    if page_table is None:
        raise ValueError("paged KV cache needs a page_table")
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                         f"got {attn_impl!r}")
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.has_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, hd)
    cache = paged_cache_update(cache, k, v, page_table, cache_pos, kv_quant,
                               valid_len=kv_valid_len)
    odt = torch.bfloat16 if cfg.attn_bf16 else torch.float32
    o = route_paged_attention(q, cache, page_table, positions, cache_pos,
                              cfg=cfg, attn_impl=attn_impl,
                              operand_dtype=odt)
    y = o.reshape(B, S, H * hd) @ p.wo
    return y, cache
