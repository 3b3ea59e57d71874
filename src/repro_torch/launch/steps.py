"""Step functions: the training step (loss and gradients, optional
gradient compression with error feedback, AdamW) and the serving steps:
whole-prompt prefill into dense caches (an encoder's whole forward),
bucketed chunk prefill, decode (from token ids or, for a stub-frontend
arch, from embeddings), and the fused ragged step. The forward's aux
output (a MoE model's load-balance loss) is not used in serving.

Plain functions on tensors (PyTorch runs eagerly; the reference wraps the
same bodies in ``jax.jit``). Caches are the per-layer list of
``models.transformer.init_cache`` and are updated in place; the training
step updates its state in place. The serving steps run without autograd.

A train state is ``{"params": Transformer (trainable), "opt": AdamW
state, "ef_residual": residuals}`` (the last with gradient compression),
the optimizer's leaves keyed by parameter name; :func:`train_state_tree`
nests it as the reference's tree for checkpoints, and
:func:`load_train_state` writes such a tree back.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch

from ..models.transformer import (Transformer, forward_hidden, init_cache,
                                  init_model, reference_layout,
                                  reference_tree, train_loss,
                                  unstack_reference_tree)
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.compress import (CompressionConfig, compress_gradients,
                              error_feedback_init)


@dataclasses.dataclass(frozen=True)
class TrainHParams:
    lr: float = 3e-4
    adamw: AdamWConfig = AdamWConfig()
    lb_coeff: float = 0.01
    grad_compress: Optional[CompressionConfig] = None


def init_train_state(cfg, hp: TrainHParams, *, seed: int = 0,
                     device="cuda", model: Optional[Transformer] = None):
    """A fresh train state: ``model`` (a trainable :class:`Transformer`)
    or a random one from ``seed``, zero AdamW moments, and with gradient
    compression a zero float32 residual per parameter."""
    if model is None:
        model = init_model(cfg, seed=seed, device=device, trainable=True)
    if not model.trainable:
        raise ValueError("the train state needs a trainable model "
                         "(float32 masters with gradients on)")
    state = {"params": model, "opt": adamw_init(model, hp.adamw)}
    if hp.grad_compress is not None:
        state["ef_residual"] = error_feedback_init(model.named_parameters())
    return state


def reference_decay(model: Transformer, cfg) -> frozenset:
    """Names of the parameters the reference's AdamW decays: those of rank
    >= 2 in the reference's tree, where every layer leaf carries a leading
    period axis (so a layer's norm scales and QKV biases are decayed, the
    final norm and the MTP module's 1-D leaves are not)."""
    params = dict(model.named_parameters())
    return frozenset(n for n, _, p in reference_layout(model, cfg)
                     if p is not None or params[n].dim() >= 2)


def reference_groups(model: Transformer, cfg) -> tuple:
    """The parameters that make up one leaf of the reference's tree, a
    tuple of name tuples: each layer leaf's periods (its stacked leaf),
    for the leaves of more than one period. The int8 wire gives each
    group one scale, as the reference gives its stacked leaf."""
    groups = {}
    for n, path, p in reference_layout(model, cfg):
        if p is not None:
            groups.setdefault(path, []).append(n)
    return tuple(tuple(g) for g in groups.values() if len(g) > 1)


def make_train_step(cfg, hp: TrainHParams, *, quant=None):
    """fn(state, batch, *, lr=None) -> (state, metrics): loss and
    gradients, then (with ``hp.grad_compress``) the int8 wire with error
    feedback, one scale per leaf of the reference's tree
    (:func:`reference_groups`), then AdamW at ``lr`` (``hp.lr`` when
    None: a schedule passes each step's rate); the state is updated in
    place. ``batch`` is :func:`models.transformer.train_loss`'s. A
    parameter the loss never reads (a frontend arch's embedding table fed
    embeddings) has a zero gradient, as the reference's ``jax.grad``
    gives it: it adds nothing to the grad norm, goes through the wire as
    zeros, and AdamW ages its moments and decays it. Metrics: the loss
    terms of ``train_loss``, ``grad_norm`` and ``clip`` (0-dim
    tensors)."""
    layouts = weakref.WeakKeyDictionary()   # model -> (decay, groups)

    def step(state, batch, *, lr=None):
        model = state["params"]
        if model not in layouts:
            layouts[model] = (reference_decay(model, cfg),
                              reference_groups(model, cfg))
        decay, groups = layouts[model]
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        with torch.enable_grad():
            loss, metrics = train_loss(model, batch, cfg, quant=quant,
                                       lb_coeff=hp.lb_coeff)
            loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        if hp.grad_compress is not None:
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in grads.items()}
            grads, state["ef_residual"] = compress_gradients(
                grads, state["ef_residual"], hp.grad_compress,
                groups=groups)
        _, state["opt"], opt_metrics = adamw_update(
            params, grads, state["opt"], hp.lr if lr is None else lr,
            hp.adamw, decay=decay)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return state, metrics

    return step


def train_state_tree(state, cfg, *, device="cpu"):
    """The train state nested as the reference's tree (``params``,
    ``opt`` {"step", "m", "v"}, ``ef_residual``), every layer leaf stacked
    on its period axis, as tensors on ``device`` (``"meta"``: shapes and
    dtypes only, a restore template)."""
    model = state["params"]

    def nest(values):
        moved = {n: ({k: x.detach().to(device) for k, x in v.items()}
                     if isinstance(v, dict) else v.detach().to(device))
                 for n, v in values.items()}
        return reference_tree(moved, model, cfg, stack=torch.stack)

    out = {"params": nest(dict(model.named_parameters())),
           "opt": {"step": state["opt"]["step"].detach().to(device),
                   "m": nest(state["opt"]["m"]),
                   "v": nest(state["opt"]["v"])}}
    if "ef_residual" in state:
        out["ef_residual"] = nest(state["ef_residual"])
    return out


@torch.no_grad()
def load_train_state(state, tree, cfg):
    """Write a tree of :func:`train_state_tree`'s layout (a restored
    checkpoint, this package's or the reference's) into ``state`` in
    place."""
    model = state["params"]

    def copy(dst, src):
        if isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k])
        else:
            dst.copy_(src.to(dst.device))

    copy(dict(model.named_parameters()),
         unstack_reference_tree(tree["params"], model, cfg))
    state["opt"]["step"].copy_(tree["opt"]["step"])
    for k in ("m", "v"):
        copy(state["opt"][k], unstack_reference_tree(tree["opt"][k], model,
                                                     cfg))
    if "ef_residual" in state:
        copy(state["ef_residual"],
             unstack_reference_tree(tree["ef_residual"], model, cfg))
    return state


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
            return model.logits(x), None
        B = (tokens if tokens is not None else inputs["embeds"]).shape[0]
        caches = init_cache(cfg, quant, None, model.device, batch=B,
                            max_len=max_len)
        x, caches, _ = forward_hidden(model, tokens, cfg, quant=quant,
                                      caches=caches, cache_pos=0, **inputs)
        return model.logits(x)[:, -1], caches

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
        logits = model.logits(x)[:, 0]
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
        logits = model.logits(h)[:, 0]
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
        logits = model.logits(x)[:, 0]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, caches

    return step
