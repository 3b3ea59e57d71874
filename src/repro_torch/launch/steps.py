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

Under a mesh (``make_train_step(plan=)``) the state is SPMD over a
``torch.distributed`` group: :func:`shard_train_state` keeps this rank's
shard of every leaf under the reference's training placements
(``parallel.sharding.state_specs``), and the step gathers each parameter
whole before its forward (``parallel.hints.gather_param``), so it
computes the single-device step's function, as GSPMD does for the
reference's ``pjit``'d step. Its reductions are global: the batch's rows split over
the data axes (``parallel.sharding.shard_batch``), the loss the global
masked mean, the load-balance loss the global batch's, the gradients
summed over the ranks of other rows, and the grad norm, the wire's
absmax and the int8 moments' per-row absmax taken over whole leaves
(``parallel.hints.ShardReductions``). The one exception is the
reference's expert-parallel MoE (``models.moe.expert_parallel``): its
expert stacks stay E / tp a rank (gathered over "data" only) and its
forward runs under ``parallel.hints.train_step_mark``, which dispatches
each token shard with its own capacity over an all-to-all, as the
reference's ``shard_map`` does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Optional

import torch

from ..models.moe import MoE, expert_parallel
from ..models.transformer import (Transformer, forward_hidden, init_cache,
                                  init_model, reference_layout,
                                  reference_tree, train_loss,
                                  unstack_reference_tree)
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from ..optim.compress import (CompressionConfig, compress_gradients,
                              error_feedback_init)
from ..parallel.hints import (ShardReductions, all_reduce_over, gather_param,
                              kv_heads, train_step_mark)
from ..parallel.sharding import (_axes, gather_whole, local_shard,
                                 shard_batch, state_specs)


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


def _meta_state(cfg, *, int8: bool, residual: bool) -> dict:
    """A train state of ``cfg``'s global shapes on the meta device (the
    leaves ``adamw_init`` and ``error_feedback_init`` make, unfilled)."""
    model = Transformer(cfg, device="meta", trainable=True)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def moment(p):
        if not int8:
            return empty(p.shape)
        return {"q": empty(p.shape, torch.int8),
                "scale": empty(p.shape[:-1] + (1,))}

    named = dict(model.named_parameters())
    state = {"params": model,
             "opt": {"step": empty((), torch.int32),
                     "m": {n: moment(p) for n, p in named.items()},
                     "v": {n: moment(p) for n, p in named.items()}}}
    if residual:
        state["ef_residual"] = {n: empty(p.shape) for n, p in named.items()}
    return state


def train_state_specs(state, cfg, plan) -> dict:
    """``parallel.sharding.state_specs`` of a train state laid out as
    ``state`` (its moments' kind, its residuals), whole or sharded: the
    specs come from ``cfg``'s global shapes."""
    first = next(iter(state["opt"]["m"].values()))
    return state_specs(_meta_state(cfg, int8=isinstance(first, dict),
                                   residual="ef_residual" in state),
                       cfg, plan)


def _shard_leaf(t, spec, plan):
    """This rank's shard of ``t`` as a tensor of its own (``t`` itself
    when the shard is the whole)."""
    piece = local_shard(t, spec, plan)
    return t if piece.shape == t.shape else piece.clone()


@torch.no_grad()
def shard_train_state(state, cfg, plan):
    """Keep only this rank's shard of every leaf of the whole train state
    ``state`` under ``plan`` (``parallel.sharding.state_specs``): the
    float32 masters (each parameter's data replaced in place), the
    moments (an int8 moment's ``q`` and ``scale``) and the residuals.
    Returns ``state``."""
    specs = train_state_specs(state, cfg, plan)
    for name, p in state["params"].named_parameters():
        p.data = _shard_leaf(p.data, specs["params"][name], plan)

    def shard(values, spec):
        for name, v in values.items():
            if isinstance(v, dict):
                shard(v, spec[name])
            else:
                values[name] = _shard_leaf(v, spec[name], plan)

    for k in ("m", "v"):
        shard(state["opt"][k], specs["opt"][k])
    if "ef_residual" in state:
        shard(state["ef_residual"], specs["ef_residual"])
    return state


@contextlib.contextmanager
def _swapped(model: Transformer, tensors):
    """``model`` reading ``tensors`` (name -> tensor) in place of its
    parameters while the context is open."""
    saved = []
    for name, t in tensors.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        saved.append((mod, leaf, mod._parameters[leaf]))
        mod._parameters[leaf] = t
    try:
        yield
    finally:
        for mod, leaf, p in saved:
            mod._parameters[leaf] = p


def _share(labels, mask, axes, plan) -> torch.Tensor:
    """This rank's share of a global masked mean: its valid tokens over
    the batch's (each at least 1, as ``models.common.cross_entropy``
    divides), 1.0 exactly when the rank holds every row."""
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    n = torch.sum(valid.to(torch.float32))
    total = all_reduce_over(n.clone(), axes, plan)
    return torch.clamp(n, min=1.0) / torch.clamp(total, min=1.0)


def _expert_leaves(model: Transformer) -> frozenset:
    """Names of the MoE expert stacks of ``model``."""
    return frozenset(f"{n}.{leaf}" for n, m in model.named_modules()
                     if isinstance(m, MoE)
                     for leaf in ("w_gate", "w_up", "w_down"))


def _sharded_loss_backward(model, batch, cfg, plan, specs, *, quant,
                           lb_coeff) -> dict:
    """The sharded step's forward and backward: each parameter gathered
    whole (an expert-parallel expert stack gathered over every axis but
    "model"), this rank's rows through ``train_loss`` under the step's
    mark, each token-mean loss term weighted by the rank's share of its
    tokens, so that the sum over the ranks of other rows is the global
    masked mean (the load-balance loss is global already, its gradient
    this rank's part); the backward leaves each parameter's gradient
    shard, summed over those ranks, in its ``grad``. Returns the global
    metrics."""
    rows = shard_batch(batch, plan)
    axes = _axes(rows.axes)
    keep = (plan.model_axis,) if expert_parallel(cfg, plan) else ()
    experts = _expert_leaves(model) if keep else frozenset()
    whole = {n: gather_param(p, specs[n], axes, plan,
                             keep=keep if n in experts else ())
             for n, p in model.named_parameters()}
    with _swapped(model, whole), train_step_mark(plan, axes):
        _, metrics = train_loss(model, rows, cfg, quant=quant,
                                lb_coeff=lb_coeff)
    share = {"ce_loss": _share(rows["labels"], rows.get("mask"), axes,
                               plan)}
    local = metrics["ce_loss"] * share["ce_loss"]
    if cfg.num_experts:
        local = local + lb_coeff * metrics["moe_lb_loss"]
    if cfg.mtp_depth > 0:
        share["mtp_loss"] = _share(rows["labels"][:, 1:], None, axes, plan)
        local = local + 0.3 * (metrics["mtp_loss"] * share["mtp_loss"])
    local.backward()
    out = {}
    for k, v in metrics.items():
        if k in share:
            out[k] = all_reduce_over(v.detach() * share[k], axes, plan)
    # the loss as train_loss sums it, from the global terms
    loss = out["ce_loss"]
    out["moe_lb_loss"] = metrics["moe_lb_loss"].detach()
    if cfg.num_experts:
        loss = loss + lb_coeff * out["moe_lb_loss"]
    if cfg.mtp_depth > 0:
        loss = loss + 0.3 * out["mtp_loss"]
    out["loss"] = loss
    return out


def loss_and_grads(model: Transformer, batch, cfg, *, quant=None,
                   lb_coeff: float = 0.01, plan=None, specs=None):
    """The train step's loss and backward: (metrics, {name: gradient or
    None}). ``plan``: the sharded step's (``specs``: the parameters'
    specs, :func:`train_state_specs`), each gradient this rank's shard of
    the whole one and the metrics global."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    with torch.enable_grad():
        if plan is None:
            loss, metrics = train_loss(model, batch, cfg, quant=quant,
                                       lb_coeff=lb_coeff)
            loss.backward()
        else:
            metrics = _sharded_loss_backward(model, batch, cfg, plan, specs,
                                             quant=quant, lb_coeff=lb_coeff)
    grads = {n: p.grad for n, p in params.items()}
    for p in params.values():
        p.grad = None
    return metrics, grads


def make_train_step(cfg, hp: TrainHParams, *, quant=None, plan=None):
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
    tensors).

    ``plan``: the sharded step over the plan's mesh (see the module's
    docstring) on a state from :func:`shard_train_state`; ``batch`` the
    global batch or this rank's rows of it (``parallel.sharding.
    shard_batch``, as ``data.pipeline.DataPipeline(plan=)`` yields them).
    Under a mesh of one rank it is the plain step bit for bit, but for a
    ``scatter`` MoE under a plan with a model axis: that dispatches
    expert-parallel, as the reference's, and so applies the
    ``moe_a2a_bits`` wire (C10-port)."""
    layouts = weakref.WeakKeyDictionary()   # model -> (decay, groups)
    specs = shards = None
    if plan is not None:
        specs = train_state_specs(
            _meta_state(cfg, int8=hp.adamw.quantize_moments,
                        residual=hp.grad_compress is not None),
            cfg, plan)["params"]
        shards = ShardReductions(plan, specs)

    def step(state, batch, *, lr=None):
        model = state["params"]
        if model not in layouts:
            layouts[model] = (reference_decay(model, cfg),
                              reference_groups(model, cfg))
        decay, groups = layouts[model]
        params = dict(model.named_parameters())
        metrics, grads = loss_and_grads(model, batch, cfg, quant=quant,
                                        lb_coeff=hp.lb_coeff, plan=plan,
                                        specs=specs)
        if hp.grad_compress is not None:
            grads = {n: torch.zeros_like(params[n]) if g is None else g
                     for n, g in grads.items()}
            grads, state["ef_residual"] = compress_gradients(
                grads, state["ef_residual"], hp.grad_compress,
                groups=groups, shards=shards)
        _, state["opt"], opt_metrics = adamw_update(
            params, grads, state["opt"], hp.lr if lr is None else lr,
            hp.adamw, decay=decay, shards=shards)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return state, metrics

    return step


def train_state_tree(state, cfg, *, device="cpu", plan=None):
    """The train state nested as the reference's tree (``params``,
    ``opt`` {"step", "m", "v"}, ``ef_residual``), every layer leaf stacked
    on its period axis, as tensors on ``device`` (``"meta"``: global
    shapes and dtypes only, a restore template). ``plan``: ``state``
    holds this rank's shards (:func:`shard_train_state`), and each leaf
    is gathered whole first (a collective: every rank calls it), so the
    tree is the global one on every rank."""
    model = state["params"]
    step = state["opt"]["step"]
    specs = {}
    if device == "meta":
        first = next(iter(state["opt"]["m"].values()))
        state = _meta_state(cfg, int8=isinstance(first, dict),
                            residual="ef_residual" in state)
    elif plan is not None:
        specs = train_state_specs(state, cfg, plan)

    def whole(x, spec):
        x = x.detach()
        return (x if spec is None else gather_whole(x, spec, plan)).to(
            device)

    def nest(values, spec):
        moved = {n: ({k: whole(x, None if spec is None else spec[n][k])
                      for k, x in v.items()} if isinstance(v, dict)
                     else whole(v, None if spec is None else spec[n]))
                 for n, v in values.items()}
        return reference_tree(moved, model, cfg, stack=torch.stack)

    opt = specs.get("opt", {})
    out = {"params": nest(dict(state["params"].named_parameters()),
                          specs.get("params")),
           "opt": {"step": step.detach().to(device),
                   "m": nest(state["opt"]["m"], opt.get("m")),
                   "v": nest(state["opt"]["v"], opt.get("v"))}}
    if "ef_residual" in state:
        out["ef_residual"] = nest(state["ef_residual"],
                                  specs.get("ef_residual"))
    return out


@torch.no_grad()
def load_train_state(state, tree, cfg, *, plan=None):
    """Write a tree of :func:`train_state_tree`'s layout (a restored
    checkpoint, this package's or the reference's; global shapes) into
    ``state`` in place; with ``plan``, ``state`` holds this rank's shards
    (:func:`shard_train_state`) and each keeps its shard of the tree's
    leaf."""
    model = state["params"]
    specs = None if plan is None else train_state_specs(state, cfg, plan)

    def copy(dst, src, spec):
        if isinstance(dst, dict):
            for k in dst:
                copy(dst[k], src[k], None if spec is None else spec[k])
        else:
            if spec is not None:
                src = local_shard(src, spec, plan)
            dst.copy_(src.to(dst.device))

    def sp(*keys):
        out = specs
        for k in keys:
            out = None if out is None else out[k]
        return out

    copy(dict(model.named_parameters()),
         unstack_reference_tree(tree["params"], model, cfg), sp("params"))
    state["opt"]["step"].copy_(tree["opt"]["step"])
    for k in ("m", "v"):
        copy(state["opt"][k], unstack_reference_tree(tree["opt"][k], model,
                                                     cfg), sp("opt", k))
    if "ef_residual" in state:
        copy(state["ef_residual"],
             unstack_reference_tree(tree["ef_residual"], model, cfg),
             sp("ef_residual"))
    return state


def make_prefill_step(cfg, *, max_len: int, quant=None):
    """fn(model, tokens (B, S) or None, **inputs) -> (last logits (B, V),
    caches); ``inputs`` (``embeds`` (B, S, D) in place of tokens,
    ``positions``, ``mrope_positions``) as
    ``models.transformer.forward_hidden``. An encoder returns (logits
    (B, S, V), None): its whole forward, no cache.

    The whole-prompt prefill against fresh DENSE ``max_len`` caches; the
    server prefills incrementally into its caches through
    :func:`make_chunk_prefill_step` (paged) or decode steps (dense). Under
    a tensor-parallel plan (``parallel.hints.activation_hints``) the
    caches hold this rank's KV heads (``parallel.hints.kv_heads``), as
    the server's pools do."""

    @torch.no_grad()
    def step(model, tokens=None, **inputs):
        if cfg.family == "encoder":
            x, _, _ = forward_hidden(model, tokens, cfg, quant=quant,
                                     **inputs)
            return model.logits(x), None
        B = (tokens if tokens is not None else inputs["embeds"]).shape[0]
        caches = init_cache(cfg, quant, None, model.device, batch=B,
                            max_len=max_len, kv_heads=kv_heads(cfg))
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
