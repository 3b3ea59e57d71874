"""Activation-sharding hints and the tensor-parallel collectives of the
serving path.

Model code declares LOGICAL axes; a launcher activates a plan
(:func:`activation_hints`) around its step functions. With no active
plan (unit tests, one device) every function here is an exact no-op, so
model code stays mesh-free, as the reference's.

The reference lets GSPMD place activations (``with_sharding_constraint``)
and insert the collectives. The port runs SPMD over local shards
instead: each rank holds its shards of the weights and of the paged pool
(``parallel.sharding``), and the collectives are explicit. A sharded
parameter carries its sharded dim as ``tp_dim`` (set by
``launch.serve.shard_model``), and the collectives key on it:

* :func:`full` all-gathers a parameter the computation needs whole (a
  layer's norm scale, which the reference's generic 2-D rule shards);
* :func:`reduce_rows` all-reduces (sum) the partial product of a
  row-parallel weight (``wo``, ``w_down``);
* :func:`gather_cols` all-gathers the output of a column-parallel lookup
  or product whose weight is sharded on its last dim (the embedding's
  D shards, the LM head's vocab shards: the argmax then reads whole
  logits and breaks ties at the lowest index, as unsharded);
* :func:`pool_max` all-reduces (max) a page-scale write's per-token
  absmax over every rank's KV heads, so the replicated scales stay equal
  on every rank (``core.paged_kv.paged_update``'s ``amax_reduce``).

Every rank runs the same host scheduler, which must decide alike on
every rank: :func:`first_rank_value` hands each rank the model group's
first rank's reading of a host input that differs between ranks (the
wall clock's TPOT slowdown, a deadline-miss predictor feature).

Logical names: "dp" -> the batch axes; "tp" / "ep" -> "model"; None ->
skip. Every assignment is divisibility-checked like
``parallel.sharding``.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from .sharding import MeshPlan

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_hints", default=None)


@contextlib.contextmanager
def activation_hints(plan: MeshPlan):
    token = _ACTIVE.set(plan)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_plan() -> Optional[MeshPlan]:
    """The MeshPlan installed by :func:`activation_hints`, or None."""
    return _ACTIVE.get()


def model_shards(dim: int) -> int:
    """How many ways ``dim`` is sharded over the model axis under the
    active plan (1 with no plan or when the axis does not divide it)."""
    plan = _ACTIVE.get()
    if plan is None or plan.model_axis is None:
        return 1
    n = plan.model_size
    return n if dim % n == 0 else 1


def constrain(x, *logical, full=None):
    """``x`` as it is. ``logical``: one entry per dim ("dp" | "tp" | "ep" |
    None). With a plan active, checks ``x``'s LOCAL shape: one logical
    entry per dim, and, given ``full`` (the global shape), each "tp" / "ep"
    dim holding its shard (``full[d] // model_shards(full[d])``) and every
    other dim whole; a mismatch raises ``AssertionError``."""
    if _ACTIVE.get() is None:
        return x
    assert len(logical) == x.ndim, (logical, tuple(x.shape))
    if full is not None:
        want = tuple(n // model_shards(n) if name in ("tp", "ep") else n
                     for n, name in zip(full, logical))
        assert tuple(x.shape) == want, (logical, tuple(x.shape), want)
    return x


def _sharded(t) -> Optional[int]:
    """``t``'s sharded dim, or None; a sharded tensor outside an active
    plan raises (it would compute on a shard as if it were whole)."""
    d = getattr(t, "tp_dim", None)
    if d is not None and _ACTIVE.get() is None:
        raise RuntimeError("a tensor-parallel shard was used outside "
                           "activation_hints(plan)")
    return d


def _group():
    return _ACTIVE.get().model_group()


def _all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    import torch.distributed as dist
    group = _group()
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a sharded parameter (``t`` itself when it is
    not sharded)."""
    d = _sharded(t)
    return t if d is None else _all_gather(t, d)


def reduce_rows(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``y = x @ w`` summed over every rank when ``w`` is row-parallel
    (sharded on its contraction dim 0), else ``y``."""
    if _sharded(w) != 0:
        return y
    import torch.distributed as dist
    dist.all_reduce(y, group=_group())
    return y


def gather_cols(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The whole last dim of ``y``, the output of a lookup into or a
    product with ``w``, when ``w`` is sharded on its last dim, else
    ``y``."""
    d = _sharded(w)
    if d is None or d != w.dim() - 1:
        return y
    return _all_gather(y, y.dim() - 1)


def pool_max(amax: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """``amax`` (a max over a page's local KV heads) maxed over every
    rank. ``pages`` must hold this rank's KV-head shard: an unmarked pool
    raises, since its "replicated" page scales would part between
    ranks."""
    if _sharded(pages) is None:
        raise RuntimeError("a page-scale write under a tensor-parallel "
                           "plan into a pool not marked as a KV-head "
                           "shard (tp_dim)")
    import torch.distributed as dist
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=_group())
    return amax


def first_rank_value(value: float, plan: MeshPlan, device) -> float:
    """``value`` as the first rank of ``plan``'s model group read it (a
    float64 broadcast on ``device``'s backend)."""
    import torch.distributed as dist
    group = plan.model_group()
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t.item()
