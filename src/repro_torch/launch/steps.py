"""Serving step functions: whole-prompt prefill into dense caches (an
encoder's whole forward), bucketed chunk prefill, decode (from token ids
or, for a stub-frontend arch, from embeddings), and the fused ragged step.
The forward's aux output (a MoE model's load-balance loss) is not used in
serving.

Plain functions on tensors (PyTorch runs eagerly; the reference wraps the
same bodies in ``jax.jit``). Caches are the per-layer list of
``models.transformer.init_cache`` and are updated in place. The training
step is still to port (ROADMAP queue A item 12).
"""
from __future__ import annotations

import torch

from ..models.common import lm_head
from ..models.transformer import forward_hidden, init_cache


def make_prefill_step(cfg, *, max_len: int, quant=None):
    """fn(model, tokens (B, S) or None, **inputs) -> (last logits (B, V),
    caches); ``inputs`` (``embeds`` (B, S, D) in place of tokens,
    ``positions``, ``mrope_positions``) as
    ``models.transformer.forward_hidden``. An encoder returns (logits
    (B, S, V), None): its whole forward, no cache.

    The whole-prompt prefill against fresh DENSE ``max_len`` caches; the
    server prefills incrementally into its caches through
    :func:`make_chunk_prefill_step` (paged) or decode steps (dense)."""

    @torch.no_grad()
    def step(model, tokens=None, **inputs):
        if cfg.family == "encoder":
            x, _, _ = forward_hidden(model, tokens, cfg, quant=quant,
                                     **inputs)
            return lm_head(model.head_weight(), x), None
        B = (tokens if tokens is not None else inputs["embeds"]).shape[0]
        caches = init_cache(cfg, quant, None, model.device, batch=B,
                            max_len=max_len)
        x, caches, _ = forward_hidden(model, tokens, cfg, quant=quant,
                                      caches=caches, cache_pos=0, **inputs)
        return lm_head(model.head_weight(), x)[:, -1], caches

    return step


def make_chunk_prefill_step(cfg, *, quant=None, attn_impl: str = "gather"):
    """fn(model, tokens (Bp, S), start_pos (Bp,), valid_len (Bp,), caches,
    page_table (Bp, NP)) -> caches.

    One bucketed prefill program: a whole prompt chunk per row through the
    backbone in one forward, writing K/V into the paged pools. Only the
    first ``valid_len`` tokens of a row are real; padded tails write to the
    scratch page and their hidden states are never read. Skips the LM head
    (prefill logits are never sampled)."""

    @torch.no_grad()
    def step(model, tokens, start_pos, valid_len, caches, page_table):
        _, caches, _ = forward_hidden(model, tokens, cfg, quant=quant,
                                      caches=caches, cache_pos=start_pos,
                                      page_table=page_table,
                                      attn_impl=attn_impl,
                                      kv_valid_len=valid_len)
        return caches

    return step


def make_decode_step(cfg, *, quant=None, attn_impl: str = "gather"):
    """fn(model, tokens (B,), pos, caches, page_table) ->
    (next_tokens (B,) int32, logits (B, V), caches).

    One new token per row; ``pos`` is a scalar or (B,) per-row lengths.
    Greedy: ``argmax`` takes the first maximal logit, as ``jnp.argmax``."""

    @torch.no_grad()
    def step(model, tokens, pos, caches, page_table):
        x, caches, _ = forward_hidden(model, tokens[:, None], cfg,
                                      quant=quant,
                                      caches=caches, cache_pos=pos,
                                      page_table=page_table,
                                      attn_impl=attn_impl)
        logits = lm_head(model.head_weight(), x)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches

    return step


def make_fused_step(cfg, *, quant=None, attn_impl: str = "gather"):
    """fn(model, tokens (R, S), start_pos (R,), valid_len (R,), caches,
    page_table (R, NP), emit_idx (R,)) -> (next_tokens (R,) int32,
    logits (R, V), caches).

    ONE ragged program per scheduler cycle: every row is a decode row (its
    single next token, ``valid_len == 1``) or a prefill chunk row
    (``valid_len`` real prompt tokens padded to the shared bucket S), each
    with its own page table and start position. Padded tails write to the
    scratch page and their outputs are never read: every real query's
    causal bound lies below the padded keys. Attention goes through
    ``route_paged_attention`` (the CUDA kernel on the card with
    ``attn_impl="kernel"``, which takes per-row ``q_start``/``kv_len``).

    The LM head runs only on the ``emit_idx`` rows, each at its LAST real
    position (``valid_len - 1``); callers keep ``emit_idx`` a fixed (R,)
    shape, padded with row 0, and discard the padding on the host. At
    S == 1 with ``emit_idx == arange(R)`` and ``valid_len == 1`` (the
    steady state) the gathers are identity copies and the head GEMM has
    :func:`make_decode_step`'s shape and operands."""

    @torch.no_grad()
    def step(model, tokens, start_pos, valid_len, caches, page_table,
             emit_idx):
        x, caches, _ = forward_hidden(model, tokens, cfg, quant=quant,
                                      caches=caches, cache_pos=start_pos,
                                      page_table=page_table,
                                      attn_impl=attn_impl,
                                      kv_valid_len=valid_len)
        emit = emit_idx.to(torch.int64)
        h = x[emit]                                          # (E, S, D)
        last = valid_len.to(torch.int64)[emit] - 1           # (E,)
        h = torch.gather(h, 1, last[:, None, None].expand(
            -1, 1, h.shape[-1]))                             # (E, 1, D)
        logits = lm_head(model.head_weight(), h)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches

    return step


def make_embed_decode_step(cfg, *, quant=None):
    """fn(model, embeds (B, 1, D), pos, caches) -> (next_tokens (B,) int32,
    logits (B, V), caches): the decode step of a stub-frontend arch, its
    input an embedding, on dense caches. No M-RoPE ids reach it, so an
    M-RoPE arch decodes with plain RoPE at ``pos``, as the reference's
    does (M-RoPE with three equal ids)."""

    @torch.no_grad()
    def step(model, embeds, pos, caches):
        x, caches, _ = forward_hidden(model, None, cfg, embeds=embeds,
                                      quant=quant, caches=caches,
                                      cache_pos=pos)
        logits = lm_head(model.head_weight(), x)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches

    return step
