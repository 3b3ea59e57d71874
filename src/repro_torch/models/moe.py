"""Mixture-of-Experts FFN with top-k routing (Llama 4, DeepSeek-V3).

Two dispatch modes, as the reference's ``repro.models.moe``:

* ``eval_all`` — every expert runs on every token and the top-k outputs
  are combined by router weight, slot by slot in the compute dtype. Exact
  (no capacity drops).
* ``scatter`` — capacity-bounded dispatch: the T*k assignments, taken
  token-major, are placed into an (E, C, D) buffer at their position in
  their expert (a one-hot cumsum), assignments past the capacity
  ``C = max(1, ceil(T*k/E * capacity_factor))`` are dropped (they add
  zeros into slot C - 1, as the reference's ``.at[].add``), a batched
  SwiGLU runs per expert, and the kept rows gather back.

Router: softmax over the top-k logits, or DeepSeek-V3's sigmoid scores
renormalized over the top k (``cfg.moe_sigmoid_router``). The top k is a
stable descending sort, so tied scores take the lower expert index first,
as ``jax.lax.top_k`` does (``torch.topk`` promises no order among ties).
Aux: the Switch load-balance loss and the router z-loss.

Expert parallelism, as the reference's ``_sharded_dispatch``, in the
sharded train step only (``parallel.hints.train_step_mark``): with a
model axis that divides E, a ``scatter`` MoE cuts this rank's rows to
its S / tp share of the sequence (the whole sequence when tp does not
divide S), dispatches them with the capacity of that token shard, sends
each expert's rows to the rank holding it and back by all-to-alls over
the model axis (on the int8 / int16 wire of ``moe_a2a_bits``, whose
backward is straight-through: C10), runs the rank's E / tp experts, and
all-gathers the sequence. Routing runs before the cut, so the
load-balance loss is over the global batch (its first-choice shares and
mean probabilities summed over the ranks of other rows). Without a
model axis dividing E, ``scatter`` dispatches the global batch (the
rows gathered), as the reference's GSPMD does.

Served under tensor parallelism (``parallel.hints.activation_hints`` with
expert stacks sharded on E), every rank routes every token with the
global capacity, runs only its own experts' rows and sums the partial
outputs over the model axis: the reference's unsharded function.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..parallel.hints import (_sharded, active_plan, active_step,
                              all_reduce_over, all_to_all, axis_group,
                              gather_rows, reduce_rows, scale_grad,
                              slice_rows, sum_grad, wire_all_to_all)
from ..parallel.sharding import local_shard
from .common import dense_init_, frozen
from .mlp import SwiGLU, init_swiglu, swiglu_apply

MOE_MODES = ("eval_all", "scatter")


class MoE(nn.Module):
    """``router`` (D, E), the expert stacks ``w_gate``/``w_up`` (E, D, F)
    and ``w_down`` (E, F, D) (the reference's ``experts/...`` leaves), and
    the ``shared`` SwiGLU of width F * num_shared_experts (None without
    shared experts); all in the compute dtype, allocated uninitialized
    (see :func:`init_moe`)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        mk = lambda *shape: frozen(torch.empty(shape, dtype=dtype,
                                               device=device))
        self.router = mk(D, E)
        self.w_gate = mk(E, D, F)
        self.w_up = mk(E, D, F)
        self.w_down = mk(E, F, D)
        self.shared = (SwiGLU(D, F * cfg.num_shared_experts, dtype, device)
                       if cfg.num_shared_experts else None)


def init_moe(p: MoE, generator: torch.Generator) -> None:
    """The reference's distributions: the router truncated normal of std
    0.02, the expert stacks fan-in truncated normal with the fan-in their
    leading (expert) axis gives, ``w_down`` of std 1/sqrt(F), drawn one
    expert at a time; the shared SwiGLU as :func:`init_swiglu`."""
    dense_init_(p.router, generator, scale=0.02)
    dense_init_(p.w_gate, generator)
    dense_init_(p.w_up, generator)
    dense_init_(p.w_down, generator, scale=1.0 / np.sqrt(p.w_down.shape[1]))
    if p.shared is not None:
        init_swiglu(p.shared, generator)


def stable_topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    broken to the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: MoE, x: torch.Tensor, cfg):
    """x: (..., D) -> (weights (..., k) float32, idx (..., k) int64, aux
    {"moe_lb_loss", "moe_z_loss"})."""
    logits = (x @ p.router).to(torch.float32)
    k = cfg.experts_per_token
    if cfg.moe_sigmoid_router:
        scores = torch.sigmoid(logits)
        top_w, top_i = stable_topk(scores, k)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    else:
        top_l, top_i = stable_topk(logits, k)
        top_w = torch.softmax(top_l, dim=-1)
    # Switch load-balance loss: E * sum_e (share of tokens to e) * (mean
    # probability of e), over each token's first choice
    E = cfg.num_experts
    probs = torch.softmax(logits, dim=-1).reshape(-1, E)
    assign = nn.functional.one_hot(top_i.reshape(-1, k)[:, 0], E).to(
        torch.float32)
    mark = active_step()
    if mark is None or mark.row_ranks == 1:
        lb = E * torch.sum(assign.mean(0) * probs.mean(0))
    else:
        lb = _global_lb(assign, probs, mark)
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_w, top_i, {"moe_lb_loss": lb, "moe_z_loss": z}


def _global_lb(assign, probs, mark) -> torch.Tensor:
    """The load-balance loss over the global batch, from this rank's
    rows (``assign`` and ``probs`` (n, E)) and the same on the ranks of
    ``mark.row_axes``: its value is the global loss on every rank, its
    gradient reaches this rank's probabilities once (the global
    first-choice share A, which has none, times the local mean
    probabilities weighted by the rank's share n / N of the tokens), so
    the sum over those ranks is the global gradient."""
    E = assign.shape[1]
    n = assign.shape[0]
    N = n * mark.row_ranks              # every rank holds as many rows
    share = all_reduce_over(assign.sum(0), mark.row_axes, mark.plan) / N
    mean = all_reduce_over(probs.detach().sum(0), mark.row_axes,
                           mark.plan) / N
    local = E * torch.sum(share * (probs.mean(0) * (n / N)))
    return (E * torch.sum(share * mean)) + (local - local.detach())


def _experts_ffn(p: MoE, h: torch.Tensor) -> torch.Tensor:
    """(E, N, D) rows, one batch per expert -> (E, N, D): each expert's
    SwiGLU, silu in float32."""
    cd = h.dtype
    g = torch.bmm(h, p.w_gate)
    u = torch.bmm(h, p.w_up)
    a = nn.functional.silu(g.to(torch.float32)).to(cd) * u
    return torch.bmm(a, p.w_down)


def _dispatch(x: torch.Tensor, idx: torch.Tensor, cfg):
    """The (E, C, D) buffer of x (T, D)'s assignments by idx (T, k), with
    the capacity of these T tokens; returns (buf, each assignment's
    expert and slot, whether it was kept)."""
    T, D = x.shape
    cd = x.dtype
    E, k = cfg.num_experts, cfg.experts_per_token
    A = T * k
    C = max(1, int(np.ceil(T * k / E * cfg.moe_capacity_factor)))
    e_a = idx.reshape(A)
    oh = nn.functional.one_hot(e_a, E).to(torch.int32)
    pos = torch.gather(torch.cumsum(oh, dim=0), 1, e_a[:, None])[:, 0] - 1
    keep = pos < C
    pos_s = torch.where(keep, pos, torch.full_like(pos, C - 1))
    x_a = torch.repeat_interleave(x, k, dim=0)
    buf = torch.zeros((E, C, D), dtype=cd, device=x.device)
    buf.index_put_((e_a, pos_s), x_a * keep[:, None].to(cd), accumulate=True)
    return buf, e_a, pos_s, keep


def _combine(y: torch.Tensor, e_a, pos_s, keep, w: torch.Tensor):
    """The kept assignments' expert outputs from y (E, C, D), weighted by
    w (T, k) and summed over the k slots: (T, D)."""
    T, k = w.shape
    cd = y.dtype
    y_a = y[e_a, pos_s] * keep[:, None].to(cd)
    return (y_a.reshape(T, k, -1) * w.reshape(T, k)[..., None].to(cd)).sum(
        dim=1)


def _routed_ffn(p: MoE, x: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                cfg, mode: str, lo: int = 0) -> torch.Tensor:
    """The routed output (T, D) of x (T, D) with idx/w (T, k), by the
    experts [lo, lo + El) that ``p``'s stacks hold (El their first dim:
    every expert, or a rank's E / tp when served under tensor
    parallelism, where the rows of other ranks' experts contribute
    zeros). Routing and the capacity are those of all T tokens.
    ``scatter`` takes the assignments token-major (``idx.reshape(T*k)``)
    and an expert's slot is its one-hot cumsum count, so which
    assignments are dropped is the reference's."""
    T, D = x.shape
    cd = x.dtype
    El = p.w_gate.shape[0]
    whole = El == cfg.num_experts

    def mine(e):
        """Which of the expert ids ``e`` this rank holds (None: all), and
        their rows in its stacks."""
        if whole:
            return None, e
        return (e >= lo) & (e < lo + El), torch.clamp(e - lo, 0, El - 1)

    if mode == "eval_all":
        y_all = _experts_ffn(p, x[None].expand(El, T, D))
        rows = torch.arange(T, device=x.device)
        out = torch.zeros((T, D), dtype=cd, device=x.device)
        for j in range(idx.shape[1]):
            own, e = mine(idx[:, j])
            yj = y_all[e, rows]
            if own is not None:
                yj = torch.where(own[:, None], yj, 0.0)
            out = out + w[:, j, None].to(cd) * yj
        return out
    buf, e_a, pos_s, keep = _dispatch(x, idx, cfg)
    y = _experts_ffn(p, buf if whole else buf[lo:lo + El])
    own, e = mine(e_a)
    return _combine(y, e, pos_s, keep if own is None else keep & own, w)


def _send(t: torch.Tensor, group, bits: int) -> torch.Tensor:
    """``t`` (tp, ...) over the model group, on the wire when ``bits``."""
    if bits:
        return wire_all_to_all(t, group, bits)
    return all_to_all(t, group)


def _ep_dispatch_ffn(p: MoE, x, idx, w, cfg, mark) -> torch.Tensor:
    """The reference's ``_sharded_dispatch`` on this rank's rows x (B, S,
    D) (idx / w (B, S, k)), the same on every rank of the model axis;
    ``p``'s expert stacks are this rank's E / tp experts, whole in F."""
    plan = mark.plan
    if mark.row_axes not in ((), tuple(plan.batch_axes)):
        raise NotImplementedError(
            "expert-parallel dispatch of rows split over only some of the "
            "batch axes (a pod mesh) is not ported yet: ROADMAP queue A "
            "item 13 part 5")
    model, tp = plan.model_axis, plan.model_size
    group = axis_group(plan, model)
    bits = cfg.moe_a2a_bits
    B, S, D = x.shape
    k = idx.shape[-1]
    if S % tp == 0:
        # the model axis splits the sequence
        x, idx, w = (slice_rows(t, 1, (model,), plan) for t in (x, idx, w))
    elif tp > 1:
        # every model rank dispatches the whole sequence: the reference
        # divides the output's gradient by tp and sums the inputs' over
        # the axis, so the experts' tp copies count once
        x, w = (sum_grad(t, (model,), plan) for t in (x, w))
    Bl, Sl = x.shape[0], x.shape[1]
    T = Bl * Sl
    buf, e_a, pos_s, keep = _dispatch(x.reshape(T, D), idx.reshape(T, k), cfg)
    E, C = buf.shape[0], buf.shape[1]
    # expert rows to their owner: (E, C, D) -> (E / tp, tp * C, D)
    got = _send(buf.reshape(tp, E // tp, C, D), group, bits)
    h = got.permute(1, 0, 2, 3).reshape(E // tp, tp * C, D)
    y = _experts_ffn(p, h)
    # and back: (E / tp, tp * C, D) -> (E, C, D)
    y = y.reshape(E // tp, tp, C, D).permute(1, 0, 2, 3)
    y = _send(y, group, bits).reshape(E, C, D)
    out = _combine(y, e_a, pos_s, keep, w.reshape(T, k)).reshape(Bl, Sl, D)
    if S % tp == 0:
        return gather_rows(out, 1, (model,), plan)
    return scale_grad(out, tp) if tp > 1 else out


def moe_apply(p: MoE, x: torch.Tensor, *, cfg, mode: Optional[str] = None):
    """x: (B, S, D). Returns (y, aux). ``mode`` defaults to
    ``cfg.moe_mode``."""
    B, S, D = x.shape
    k = cfg.experts_per_token
    mode = mode or cfg.moe_mode
    if mode not in MOE_MODES:
        raise ValueError(f"unknown moe mode {mode!r}")
    T = B * S
    w, idx, aux = _route(p, x, cfg)
    x2, w2, idx2 = x.reshape(T, D), w.reshape(T, k), idx.reshape(T, k)
    # served under tensor parallelism: the experts E / tp a rank, and the
    # shared expert's row-parallel partial product summed in the same
    # all-reduce
    served = _sharded(p.w_gate) == 0
    fold = (served and p.shared is not None
            and _sharded(p.shared.w_down) == 0)
    mark = active_step() if mode == "scatter" else None
    if served:
        plan = active_plan()
        lo = p.w_gate.shape[0] * plan.mesh.get_local_rank(plan.model_axis)
        out = _routed_ffn(p, x2, idx2, w2, cfg, mode, lo).reshape(B, S, D)
        if fold:
            out = out + swiglu_apply(p.shared, x)
        out = reduce_rows(out, p.w_down)
    elif mark is not None and expert_parallel(cfg, mark.plan):
        out = _ep_dispatch_ffn(p, x, idx, w, cfg, mark)
    elif mark is not None and mark.row_ranks > 1:
        # the global batch's dispatch (its capacity), the rows gathered
        # from the ranks of other rows; this rank keeps its own rows'
        # output (a plain slice: the other rows' gradient is zero here)
        ax, plan = mark.row_axes, mark.plan
        xs, ws, ids = (gather_rows(t, 0, ax, plan) for t in (x, w, idx))
        Bg = xs.shape[0]
        out = _routed_ffn(p, xs.reshape(Bg * S, D), ids.reshape(Bg * S, k),
                          ws.reshape(Bg * S, k), cfg, mode)
        spec = (ax if len(ax) > 1 else ax[0], None, None)
        out = local_shard(out.reshape(Bg, S, D), spec, plan)
    else:
        out = _routed_ffn(p, x2, idx2, w2, cfg, mode).reshape(B, S, D)
    if p.shared is not None and not fold:
        # row-parallel under a plan whose model axis does not divide the
        # experts (the stacks then stay whole on every rank)
        out = out + reduce_rows(swiglu_apply(p.shared, x), p.shared.w_down)
    return out, aux


def expert_parallel(cfg, plan) -> bool:
    """Whether the train step under ``plan`` dispatches ``cfg``'s experts
    expert-parallel (the reference's condition: ``scatter``, a model
    axis, and E divisible by it); its expert stacks then hold E / tp
    experts a rank."""
    return (cfg.num_experts > 0 and cfg.moe_mode == "scatter"
            and plan.model_axis is not None
            and cfg.num_experts % plan.model_size == 0)
