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

Expert parallelism (the reference's ``_sharded_dispatch`` under a mesh
plan, and the int8/int16 all-to-all wire format ``moe_a2a_bits``) is
ROADMAP queue A item 13: the port has no mesh plans yet, and the refusal
of one comes with them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

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
    probs = torch.softmax(logits, dim=-1)
    assign = nn.functional.one_hot(top_i.reshape(-1, k)[:, 0], E).to(
        torch.float32)
    lb = E * torch.sum(assign.mean(0) * probs.reshape(-1, E).mean(0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_w, top_i, {"moe_lb_loss": lb, "moe_z_loss": z}


def _experts_ffn(p: MoE, h: torch.Tensor) -> torch.Tensor:
    """(E, N, D) rows, one batch per expert -> (E, N, D): each expert's
    SwiGLU, silu in float32."""
    cd = h.dtype
    g = torch.bmm(h, p.w_gate)
    u = torch.bmm(h, p.w_up)
    a = nn.functional.silu(g.to(torch.float32)).to(cd) * u
    return torch.bmm(a, p.w_down)


def _local_dispatch_ffn(p: MoE, x: torch.Tensor, idx: torch.Tensor,
                        w: torch.Tensor, cfg) -> torch.Tensor:
    """Capacity-bounded top-k dispatch and the expert FFN on x (T, D) with
    idx/w (T, k). Assignments are taken token-major (``idx.reshape(T*k)``)
    and an expert's slot is its one-hot cumsum count, so which assignments
    are dropped is the reference's."""
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
    y = _experts_ffn(p, buf)
    y_a = y[e_a, pos_s] * keep[:, None].to(cd)
    return (y_a.reshape(T, k, D)
            * w.reshape(T, k)[..., None].to(cd)).sum(dim=1)


def moe_apply(p: MoE, x: torch.Tensor, *, cfg, mode: Optional[str] = None):
    """x: (B, S, D). Returns (y, aux). ``mode`` defaults to
    ``cfg.moe_mode``."""
    B, S, D = x.shape
    cd = x.dtype
    k = cfg.experts_per_token
    mode = mode or cfg.moe_mode
    if mode not in MOE_MODES:
        raise ValueError(f"unknown moe mode {mode!r}")
    T = B * S
    w, idx, aux = _route(p, x, cfg)
    x2, w2, idx2 = x.reshape(T, D), w.reshape(T, k), idx.reshape(T, k)
    if mode == "eval_all":
        y_all = _experts_ffn(p, x2[None].expand(cfg.num_experts, T, D))
        rows = torch.arange(T, device=x.device)
        out = torch.zeros((T, D), dtype=cd, device=x.device)
        for j in range(k):
            out = out + w2[:, j, None].to(cd) * y_all[idx2[:, j], rows]
    else:
        out = _local_dispatch_ffn(p, x2, idx2, w2, cfg)
    out = out.reshape(B, S, D)
    if p.shared is not None:
        out = out + swiglu_apply(p.shared, x)
    return out, aux
