"""Serving step functions: bucketed chunk prefill and decode.

Plain functions on tensors (PyTorch runs eagerly; the reference wraps the
same bodies in ``jax.jit``). Caches are the per-layer pool list of
``models.transformer.init_cache`` and are updated in place. The fused
ragged step and the training/dense-prefill steps are still to port
(ROADMAP queue A items 5 and 12).
"""
from __future__ import annotations

import torch

from ..models.common import lm_head
from ..models.transformer import forward_hidden


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
        _, caches = forward_hidden(model, tokens, cfg, quant=quant,
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
        x, caches = forward_hidden(model, tokens[:, None], cfg, quant=quant,
                                   caches=caches, cache_pos=pos,
                                   page_table=page_table,
                                   attn_impl=attn_impl)
        logits = lm_head(model.head_weight(), x)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches

    return step
