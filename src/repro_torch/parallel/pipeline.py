"""Pipeline parallelism: the GPipe schedule over a "stage" mesh axis (the
reference's ``parallel/pipeline.py``).

SPMD over a ``torch.distributed`` process group: rank s of the 1-D
"stage" mesh holds stage s's parameters. The classic GPipe loop runs
T = M + S - 1 ticks; at tick t, stage s computes microbatch t - s when
0 <= t - s < M, then the activation ring advances one hop (stage s to
s + 1; the last stage's output drops off). The bubble fraction is
(S - 1) / (M + S - 1) (:func:`pipeline_bubble`). The output is the last
stage's buffer, broadcast to every rank (the reference's ``psum`` of the
last stage's buffer).

Differentiable, as the reference is through ``ppermute``: the ring shift
is an autograd function whose backward is the reverse shift, and the
broadcast's backward hands the last stage its own rank's cotangent (the
output is replicated, so every rank backpropagates the same loss).
Collective cost: (S - 1 + M - 1) hops of one microbatch's activations.
"""
from __future__ import annotations

from typing import Callable

import torch


def pipeline_bubble(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


def _shift(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to group rank ``to``, receive a tensor of its shape from
    group rank ``frm``."""
    import torch.distributed as dist
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x.contiguous(),
                   dist.get_global_rank(group, to), group),
        dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm),
                   group)])
    for r in reqs:
        r.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Forward: stage s's tensor to stage s + 1 (mod S). Backward: the
    cotangent back from s + 1 to s."""

    @staticmethod
    def forward(ctx, x, group, sid, n):
        ctx.group, ctx.sid, ctx.n = group, sid, n
        return _shift(x, group, (sid + 1) % n, (sid - 1) % n)

    @staticmethod
    def backward(ctx, grad):
        sid, n = ctx.sid, ctx.n
        return (_shift(grad, ctx.group, (sid - 1) % n, (sid + 1) % n),
                None, None, None)


class _FromLast(torch.autograd.Function):
    """Forward: the sum over the stages of ``x`` (the last stage's buffer,
    zeros elsewhere), on every rank. Backward: this rank's cotangent of
    the replicated output."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gpipe_apply(stage_fn: Callable, stage_params, x_mb, *, mesh,
                axis: str = "stage"):
    """Run ``x_mb`` through S stages of ``stage_fn`` with the GPipe
    schedule over ``mesh``'s ``axis`` (S ranks).

    stage_fn(params_s, x) -> y, applied per stage.
    stage_params: a pytree (nested dicts, lists or tuples of tensors)
    with a leading axis of S, as the reference's; rank s reads its
    slice.
    x_mb: (M, mb, ...) microbatched input, the same on every rank; only
    stage 0 reads it.
    Returns the (M, mb, ...) outputs of the LAST stage on every rank."""
    import torch.distributed as dist
    S = dict(zip(mesh.mesh_dim_names, mesh.shape))[axis]
    M = x_mb.shape[0]
    T = M + S - 1
    group = mesh.get_group(axis) if S > 1 else None
    sid = dist.get_group_rank(group, dist.get_rank()) if S > 1 else 0

    def mine(t):
        if isinstance(t, dict):
            return {k: mine(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(mine(v) for v in t)
        return t[sid]

    params_s = mine(stage_params)
    if S == 1:
        return torch.stack([stage_fn(params_s, x_mb[t]) for t in range(M)])
    # the reference's tick body, every stage computing every tick and
    # masking with ``where``: each ring hop then lies on every rank's
    # autograd graph, so every rank runs every hop's backward in the same
    # order
    first = torch.tensor(sid == 0, device=x_mb.device)
    buf = torch.zeros_like(x_mb)
    inflight = torch.zeros_like(x_mb[0])
    for t in range(T):
        mb_idx = t - sid
        x_in = torch.where(first, x_mb[min(t, M - 1)], inflight)
        active = torch.tensor(0 <= mb_idx < M, device=x_mb.device)
        y = stage_fn(params_s, x_in)
        y = torch.where(active, y, torch.zeros_like(y))
        slot = min(max(mb_idx, 0), M - 1)
        buf = torch.where(active, buf.index_copy(
            0, torch.tensor([slot], device=x_mb.device), y[None]), buf)
        inflight = _RingShift.apply(y, group, sid, S)
    last = torch.tensor(sid == S - 1, device=x_mb.device)
    return _FromLast.apply(torch.where(last, buf, torch.zeros_like(buf)),
                           group)
