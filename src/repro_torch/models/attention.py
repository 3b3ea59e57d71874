"""Attention: GQA (with optional QKV bias) over dense or paged KV caches,
and MLA (DeepSeek-V3) over dense latent caches.

* ``gqa_apply`` — QKV projections + bias, RoPE (M-RoPE for Qwen2-VL when
  given its (B, S, 3) ids), the cache write, attention
  and the output projection, for the reference's three cache kinds: a
  paged pool (``route_paged_attention``), a dense ``max_len`` slab
  (``cache_update`` + ``attend_chunked``), and no cache at all (training
  and whole-prompt forwards: ``attend_full`` or ``attend_chunked`` by the
  reference's ``use_chunked`` rule).
* ``init_kv_cache`` / ``cache_update`` — the dense slab: a float cache in
  the compute dtype, or an int8 grid of the layer's Q(I,F) format
  (``KVQuantSpec``; stored with ``torch.round``, half to even, as the
  reference's ``jnp.round``).
* ``paged_cache_update`` — the pool write (quantize, pack, scatter).
* ``route_paged_attention`` — ONE entry point for every paged attention
  read, chunked prefill (S > 1) and decode (S == 1) alike:
  ``attn_impl="kernel"`` sends it through the CUDA kernel of
  ``kernels.paged_kv_attention`` (its plain version on CPU tensors),
  ``"gather"`` reads the pool through the dense gather and
  ``attend_chunked``'s online softmax.

* ``mla_apply`` — DeepSeek-V3's multi-head latent attention: the query
  LoRA, the latent ``[c_kv ; k_rope]`` (the whole KV cache: a dense
  ``(batch, max_len, kv_lora_rank + rope_dim)`` slab of
  ``init_mla_cache``, on a ``KVQuantSpec`` grid or in the compute dtype),
  and either the expanded route (per-head K/V through ``attend_chunked``)
  or the absorbed one (W_uk folded into the query, W_uv into the output,
  float32 einsums in latent space). A paged latent cache is not offered,
  as in the reference.

Non-causal configs (the encoder) attend without a cache only; the paged
route keeps them off the kernel, as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..core.fixedpoint import format_params
from ..core.paged_kv import (PagedKVLayout, init_paged_pool, paged_gather,
                             paged_update, per_row, pool_container)
from ..kernels.paged_kv_attention import (paged_kv_attention_chunk,
                                          paged_kv_attention_decode)
from ..parallel.hints import (constrain, gather_cols, model_shards,
                              pool_max, replicated_heads, row_piece)
from .common import apply_mrope, apply_rope, dense_init, frozen, rmsnorm

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

    @property
    def dtype(self) -> torch.dtype:
        """The dense cache's storage dtype (paged pools keep their own
        containers; int4 exists only lane-packed in pages)."""
        if self.container == "int4":
            raise ValueError("int4 KV container requires a paged cache "
                             "(lane-packed pages); dense caches support "
                             "int8/int16")
        return {"int8": torch.int8, "int16": torch.int16}[self.container]


# ---------------------------------------------------------------------------
# Dense KV cache: one (B, max_len, KV, hd) slab per layer
# ---------------------------------------------------------------------------
def init_kv_cache(batch, max_len, n_kv, head_dim, dtype,
                  quant: Optional[KVQuantSpec], device):
    store = quant.dtype if quant is not None else dtype
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=store, device=device),
            "v": torch.zeros(shape, dtype=store, device=device)}


def init_paged_kv_cache(num_pages, page_size, n_kv, head_dim, dtype,
                        quant: Optional[KVQuantSpec] = None, device="cuda"):
    """Paged pool for one GQA layer (no batch dim: pages are shared), in
    ``quant``'s container or float pages of ``dtype``."""
    layout = PagedKVLayout(
        num_pages=num_pages, page_size=page_size, num_kv_heads=n_kv,
        head_dim=head_dim,
        container="fp" if quant is None else quant.container, dtype=dtype)
    return init_paged_pool(layout, resolve_device(device))


def _q_store(x, quant: Optional[KVQuantSpec]):
    """Float K/V -> the stored grid. ``torch.round`` rounds half to even,
    as the reference's ``jnp.round`` at this call site."""
    if quant is None:
        return x
    scale, qmin, qmax = format_params(quant.int_bits, quant.frac_bits)
    q = torch.clamp(torch.round(x.to(torch.float32) * scale), qmin, qmax)
    return q.to(quant.dtype)


def _q_load(x, quant: Optional[KVQuantSpec], dtype):
    if quant is None:
        return x.to(dtype)
    scale, _, _ = format_params(quant.int_bits, quant.frac_bits)
    return (x.to(torch.float32) / scale).to(dtype)


def seq_update(buf, new, pos):
    """Write ``new`` (B, S, ...) into ``buf`` (B, T, ...) at token offset
    ``pos``, a scalar (shared clock) or (B,) per-row offsets, in place. As
    ``lax.dynamic_update_slice``, a start past ``T - S`` is clamped to it
    so the S tokens stay inside the slab. Returns ``buf``."""
    B, S, T = new.shape[0], new.shape[1], buf.shape[1]
    if not torch.is_tensor(pos) or pos.numel() == 1:
        s0 = min(max(int(pos), 0), T - S)
        buf[:, s0:s0 + S] = new
        return buf
    start = torch.clamp(per_row(pos, B, buf.device), 0, T - S)
    rows = torch.arange(B, device=buf.device)[:, None]
    cols = start[:, None] + torch.arange(S, device=buf.device)[None, :]
    buf[rows, cols] = new
    return buf


def cache_update(cache, k_new, v_new, pos, quant=None):
    """Write S new tokens at offset ``pos`` (scalar or (B,)), in place."""
    seq_update(cache["k"], _q_store(k_new, quant).to(cache["k"].dtype), pos)
    seq_update(cache["v"], _q_store(v_new, quant).to(cache["v"].dtype), pos)
    return cache


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------
def paged_cache_update(cache, k_new, v_new, page_table, pos,
                       quant: Optional[KVQuantSpec] = None, valid_len=None):
    """Append S new tokens through the page table (pos scalar or (B,));
    ``valid_len`` sends padded chunk tails to the scratch page. Updates
    ``cache`` in place and returns it. Under a tensor-parallel plan a
    pool marked as a KV-head shard (``tp_dim``) holds this rank's KV
    heads, and a page scale's absmax is maxed over every rank's
    (``parallel.hints.pool_max``); a replicated pool holds every head and
    computes its absmax whole, alike on every rank."""
    amax_reduce = None
    if getattr(cache["k_pages"], "tp_dim", None) is not None:
        amax_reduce = functools.partial(pool_max, pages=cache["k_pages"])
    return paged_update(
        cache, k_new, v_new, page_table, pos,
        page_size=cache["k_pages"].shape[1], container=pool_container(cache),
        int_bits=None if quant is None else quant.int_bits,
        frac_bits=None if quant is None else quant.frac_bits,
        valid_len=valid_len,
        scale_mode="static" if quant is None else quant.scale_mode,
        amax_reduce=amax_reduce)


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


def attend_full(q, k, v, q_pos, kv_pos, *, causal=True):
    """Full-materialization attention (small shapes, the cache-free
    forward). q: (B, S, H, hd); k, v: (B, T, KV, hd); q_pos: (B, S);
    kv_pos: (T,). Scores and products accumulate in float32; the softmax
    is the reference's ``jax.nn.softmax`` over masked float32 scores."""
    B, S, H, hd = q.shape
    KV, vd = k.shape[2], v.shape[-1]
    G = H // KV
    qg = q.reshape(B, S, KV, G, hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg.to(torch.float32),
                     k.to(torch.float32)) / np.sqrt(hd)
    mask = torch.ones((B, S, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kv_pos[None, None, :] <= q_pos[:, :, None])
    s = torch.where(mask[:, None, None, :, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32))
    return o.reshape(B, S, H, vd).to(q.dtype)


def attend_chunked(q, k, v, q_pos, kv_start, *, causal=True, kv_len=None,
                   chunk=1024, kv_quant: Optional[KVQuantSpec] = None,
                   scale=None, operand_dtype=torch.float32):
    """Flash-style online-softmax attention, scanning KV in ``chunk``s.

    q: (B, S, H, hd); k/v: (B, T, KV, hd), float or a dense cache's integer
    grid under ``kv_quant`` (each chunk dequantized as it is read); q_pos:
    (B, S) absolute query positions. S == 1 runs grouped (B, KV, G) math
    and never expands K/V across the group; S > 1 works in expanded H-head
    space, as the reference does. Softmax state and products are
    float32."""
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
                                       chunk=chunk, kv_quant=kv_quant,
                                       scale=scale, nc=nc)
    dev = q.device
    qh = (q.to(torch.float32) * scale).to(operand_dtype)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, H, v.shape[-1]), dtype=torch.float32,
                      device=dev)
    for idx in range(nc):
        kc = _q_load(k[:, idx * chunk:(idx + 1) * chunk], kv_quant,
                     operand_dtype)
        vc = _q_load(v[:, idx * chunk:(idx + 1) * chunk], kv_quant,
                     operand_dtype)
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
                            chunk, kv_quant, scale, nc):
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
        kc = _q_load(k[:, idx * chunk:(idx + 1) * chunk], kv_quant,
                     torch.float32)
        vc = _q_load(v[:, idx * chunk:(idx + 1) * chunk], kv_quant,
                     torch.float32)
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
              mrope_positions=None, page_table=None,
              attn_impl: str = "gather", kv_valid_len=None):
    """Returns (y, cache). ``positions``: (B, S) absolute positions;
    ``mrope_positions`` (B, S, 3), given to an M-RoPE config, rotates q
    and k by M-RoPE in their place (without them, plain RoPE at
    ``positions``, as the reference serves Qwen2-VL text).

    ``cache`` is None (attend within the sequence, causal per cfg), a dense
    slab of :func:`init_kv_cache` (written at ``cache_pos``, scalar or
    (B,)), or a paged pool (needs ``page_table`` (B, NP) int32; attention
    by ``attn_impl``, "gather" | "kernel", see
    :func:`route_paged_attention`). Caches are updated in place.
    ``kv_valid_len`` (scalar or (B,)) marks only the first tokens of a
    padded prefill chunk as real (paged pools). Without a cache, the
    reference's ``use_chunked`` rule takes the online softmax once S^2
    exceeds ``cfg.attn_chunk``^2, else :func:`attend_full`.

    Under a tensor-parallel plan a rank attends over its shard of the
    heads; where the model axis does not divide the KV heads (the
    reference replicates the pool) it gathers q, k and v whole (their
    weights' column shards may cut a head), attends over every head at
    the model's own group size, and hands ``wo`` its rows of the output
    (``parallel.hints.row_piece``)."""
    B, S, _ = x.shape
    whole = replicated_heads(cfg)
    if whole:
        H, KV = cfg.num_heads, cfg.num_kv_heads
    else:
        # this rank's shard of the heads (all of them without a plan)
        H = cfg.num_heads // model_shards(cfg.num_heads)
        KV = cfg.num_kv_heads // model_shards(cfg.num_kv_heads)
    hd = cfg.head_dim
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.has_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if whole:
        q, k, v = (gather_cols(t, w) for t, w in ((q, p.wq), (k, p.wk),
                                                   (v, p.wv)))
    q, k = q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd)
    if cfg.mrope and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    v = v.reshape(B, S, KV, hd)
    heads = None if whole else "tp"
    q = constrain(q, "dp", None, heads, None,
                  full=(B, S, cfg.num_heads, hd))
    k = constrain(k, "dp", None, heads, None,
                  full=(B, S, cfg.num_kv_heads, hd))
    odt = torch.bfloat16 if cfg.attn_bf16 else torch.float32
    if cache is not None and "k_pages" in cache:
        if page_table is None:
            raise ValueError("paged KV cache needs a page_table")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, "
                             f"got {attn_impl!r}")
        cache = paged_cache_update(cache, k, v, page_table, cache_pos,
                                   kv_quant, valid_len=kv_valid_len)
        o = route_paged_attention(q, cache, page_table, positions,
                                  cache_pos, cfg=cfg, attn_impl=attn_impl,
                                  operand_dtype=odt)
    elif cache is not None:
        cache = cache_update(cache, k, v, cache_pos, kv_quant)
        kv_len = per_row(cache_pos, B, x.device) + S
        o = attend_chunked(q, cache["k"], cache["v"], positions, 0,
                           causal=cfg.causal, kv_len=kv_len,
                           chunk=cfg.attn_chunk, kv_quant=kv_quant,
                           operand_dtype=odt)
    elif S * S > cfg.attn_chunk ** 2:
        o = attend_chunked(q, k, v, positions, 0, causal=cfg.causal,
                           chunk=cfg.attn_chunk, operand_dtype=odt)
    else:
        o = attend_full(q, k, v, positions,
                        torch.arange(S, device=x.device), causal=cfg.causal)
    o = o.reshape(B, S, H * hd)
    if whole:
        o = row_piece(o, p.wo)
    return o @ p.wo, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): the cache holds only the latent (kv_lora_rank +
# rope_dim per token), and that latent is what the data bits quantize
# ---------------------------------------------------------------------------
class MLAttention(nn.Module):
    """Projections in the reference's ``(in, out)`` layout, in the compute
    dtype; the two norm scales in float32; allocated uninitialized (see
    :func:`init_mla`)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        D, H = cfg.d_model, cfg.num_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        mk = lambda *shape: frozen(torch.empty(shape, dtype=dtype,
                                               device=device))
        self.wq_a = mk(D, qr)
        self.q_norm = frozen(torch.empty(qr, dtype=torch.float32,
                                         device=device))
        self.wq_b = mk(qr, H * (dn + dr))
        self.wkv_a = mk(D, kvr + dr)
        self.kv_norm = frozen(torch.empty(kvr, dtype=torch.float32,
                                          device=device))
        self.wkv_b = mk(kvr, H * (dn + dv))
        self.wo = mk(H * dv, D)


def init_mla(p: MLAttention, generator: torch.Generator) -> None:
    """The reference's distributions: fan-in truncated normal projections,
    ``wo`` of std 1/sqrt(H * dv), unit norm scales."""
    dev = p.wq_a.device
    for w in (p.wq_a, p.wq_b, p.wkv_a, p.wkv_b):
        w.copy_(dense_init(w.shape, torch.float32, generator, dev))
    p.wo.copy_(dense_init(p.wo.shape, torch.float32, generator, dev,
                          scale=1.0 / np.sqrt(p.wo.shape[0])))
    p.q_norm.fill_(1.0)
    p.kv_norm.fill_(1.0)


def init_mla_cache(batch, max_len, cfg, dtype,
                   quant: Optional[KVQuantSpec], device):
    """A dense latent slab: (batch, max_len, kv_lora_rank + rope_dim) in
    ``quant``'s integer container, or ``dtype`` without one."""
    store = quant.dtype if quant is not None else dtype
    width = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    return {"latent": torch.zeros((batch, max_len, width), dtype=store,
                                  device=device)}


def mla_apply(p: MLAttention, x, positions, *, cfg, cache=None,
              cache_pos=None, kv_quant: Optional[KVQuantSpec] = None,
              absorbed: bool = False):
    """Returns (y, cache). The latent ``[c_kv ; k_rope]`` is written to
    ``cache`` (a dense slab of :func:`init_mla_cache`, in place, at
    ``cache_pos``: scalar or (B,)) on ``kv_quant``'s grid, or, without a
    cache, attended within the sequence.

    ``absorbed=False`` expands the latent to per-head K/V at use and runs
    :func:`attend_chunked` with scale 1/sqrt(dn + dr); ``absorbed=True``
    folds W_uk into the query and W_uv into the output and attends in
    latent space with float32 einsums (scores, softmax and both
    products)."""
    B, S, _ = x.shape
    H = cfg.num_heads
    kvr = cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    cd = x.dtype
    sm_scale = 1.0 / np.sqrt(dn + dr)
    f32 = torch.float32

    cq = rmsnorm(p.q_norm, x @ p.wq_a, cfg.norm_eps)
    q = (cq @ p.wq_b).reshape(B, S, H, dn + dr)
    q_nope = q[..., :dn]
    q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)

    kv_a = x @ p.wkv_a
    c_kv = rmsnorm(p.kv_norm, kv_a[..., :kvr], cfg.norm_eps)
    k_rope = apply_rope(kv_a[..., kvr:][:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    latent = torch.cat([c_kv, k_rope], dim=-1)          # (B, S, kvr + dr)

    if cache is not None:
        seq_update(cache["latent"], _q_store(latent, kv_quant).to(
            cache["latent"].dtype), cache_pos)
        lat_all = _q_load(cache["latent"], kv_quant, cd)
        kv_len = per_row(cache_pos, B, x.device) + S
    else:
        lat_all, kv_len = latent, None
    T = lat_all.shape[1]
    c_all, kr_all = lat_all[..., :kvr], lat_all[..., kvr:]

    wkv_b = p.wkv_b.reshape(kvr, H, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]

    if absorbed:
        q_lat = torch.einsum("bshd,khd->bshk", q_nope, w_uk)
        s = (torch.einsum("bshk,btk->bhst", q_lat.to(f32), c_all.to(f32))
             + torch.einsum("bshd,btd->bhst", q_rope.to(f32),
                            kr_all.to(f32))) * sm_scale
        t = torch.arange(T, device=x.device)
        mask = torch.ones((B, S, T), dtype=torch.bool, device=x.device)
        if cfg.causal:
            mask = mask & (t[None, None, :] <= positions[:, :, None])
        if kv_len is not None:
            mask = mask & (t[None, None, :] < _len_col(kv_len, 3, x.device))
        s = torch.where(mask[:, None], s, torch.full_like(s, NEG_INF))
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhst,btk->bshk", pr, c_all.to(f32))
        o = torch.einsum("bshk,khd->bshd", o_lat, w_uv.to(f32)).to(cd)
    else:
        k_nope = torch.einsum("btk,khd->bthd", c_all, w_uk)
        vv = torch.einsum("btk,khd->bthd", c_all, w_uv)
        k_full = torch.cat([k_nope, kr_all[:, :, None, :].expand(
            B, T, H, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        o = attend_chunked(q_full, k_full, vv, positions, 0,
                           causal=cfg.causal, kv_len=kv_len,
                           chunk=cfg.attn_chunk, scale=sm_scale,
                           operand_dtype=torch.bfloat16 if cfg.attn_bf16
                           else torch.float32)
    y = o.reshape(B, S, H * dv) @ p.wo
    return y, cache
