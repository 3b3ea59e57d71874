"""Activation-sharding hints, the tensor-parallel collectives of the
serving path and the sharded train step's collectives.

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

The sharded train step (``launch.steps.make_train_step(plan=)``) keeps
each leaf of its state as this rank's shard under the reference's
training placements and computes on whole leaves, as GSPMD computes the
reference's ``pjit`` step: :func:`gather_param` all-gathers a parameter
whole before the forward (the whole copies live until the backward has
read them: the state is sharded between steps, not within one), and its
backward hands the rank its shard of the gradient summed over the ranks
that hold other rows of the batch.
Every reduction that the reference takes over a whole leaf or a whole
batch is an explicit collective here (:class:`ShardReductions`: the
grad norm, the wire's per-leaf absmax, the int8 moments' per-row
absmax).

Expert parallelism is the one place where the sharded step computes
another function than the single-device step, as the reference's
``shard_map`` dispatch does: the step runs its forward under
:func:`train_step_mark`, and a ``scatter`` MoE then dispatches this
rank's tokens with a per-shard capacity and exchanges them with the
model axis's other ranks (:func:`all_to_all`, optionally on an int8 /
int16 wire), holding only its E / tp experts (``gather_param(keep=)``).
:func:`slice_rows` and :func:`gather_rows` move a tensor between its
whole and this rank's piece along one dim with the matching backward,
and :func:`sum_grad` / :func:`scale_grad` give a computation replicated
over an axis its gradient once. The server never sets the mark: served
MoE tokens keep the reference's unsharded dispatch.

Logical names: "dp" -> the batch axes; "tp" / "ep" -> "model"; None ->
skip. Every assignment is divisibility-checked like
``parallel.sharding``.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Dict, Optional, Sequence

import torch

from .sharding import MeshPlan, _axes, gather_whole, local_shard

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


# ---------------------------------------------------------------------------
# The sharded train step's collectives
# ---------------------------------------------------------------------------
def axis_group(plan: MeshPlan, axis: str):
    """The process group of this rank's ``axis``, or None when the axis
    has one rank (nothing to communicate)."""
    if plan.shape[axis] == 1:
        return None
    return plan.mesh.get_group(axis)


def all_reduce_over(t: torch.Tensor, axes: Sequence[str], plan: MeshPlan,
                    op: str = "sum") -> torch.Tensor:
    """``t`` reduced in place over every rank of ``axes`` (one axis after
    another; an axis of one rank is skipped)."""
    import torch.distributed as dist
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    for ax in axes:
        group = axis_group(plan, ax)
        if group is not None:
            dist.all_reduce(t, op=red, group=group)
    return t


class _GatherParam(torch.autograd.Function):
    """Forward: the whole tensor of this rank's shard. Backward: the
    whole gradient summed over the batch axes, then this rank's shard of
    it."""

    @staticmethod
    def forward(ctx, shard, spec, batch_axes, plan):
        ctx.spec, ctx.batch_axes, ctx.plan = spec, batch_axes, plan
        whole = gather_whole(shard.detach(), spec, plan)
        return whole if whole is not shard else shard.view_as(shard)

    @staticmethod
    def backward(ctx, grad):
        grad = all_reduce_over(grad.contiguous(), ctx.batch_axes, ctx.plan)
        return local_shard(grad, ctx.spec, ctx.plan), None, None, None


def gather_param(shard: torch.Tensor, spec, batch_axes, plan: MeshPlan,
                 *, keep: Sequence[str] = ()) -> torch.Tensor:
    """The whole parameter of which ``shard`` is this rank's piece under
    ``spec``, differentiable: the gradient that reaches the shard is its
    piece of the whole gradient summed over ``batch_axes`` (the axes
    whose ranks hold other rows of the batch; the ranks of any other
    axis computed the same gradient and are not summed). ``keep``: mesh
    axes not gathered, so the result stays this rank's piece along the
    dims they shard (an expert stack keeps its E / tp experts and
    gathers its F shards over "data")."""
    spec = tuple(_without(e, keep) for e in spec)
    return _GatherParam.apply(shard, spec, tuple(batch_axes), plan)


def _without(entry, keep):
    """A spec entry without the axes of ``keep``."""
    axes = tuple(a for a in _axes(entry) if a not in keep)
    return None if not axes else axes[0] if len(axes) == 1 else axes


class ShardReductions:
    """The whole-leaf reductions of AdamW and the gradient wire over a
    state sharded by ``specs`` ({parameter name: per-dim spec}) under
    ``plan``. Every rank calls each method with its own shards, in the
    same order; an axis of one rank costs nothing, so under a one-rank
    mesh each result is the unsharded computation bit for bit."""

    def __init__(self, plan: MeshPlan, specs: Dict[str, tuple]):
        self.plan, self.specs = plan, specs

    def _leaf_axes(self, name: str) -> tuple:
        return tuple(ax for e in self.specs[name] for ax in _axes(e)
                     if self.plan.shape[ax] > 1)

    def leaf_max(self, names: Sequence[str], amax: torch.Tensor
                 ) -> torch.Tensor:
        """``amax`` (a max over the local shards of ``names``, one leaf
        of the reference's tree) maxed over every axis that shards
        them."""
        axes = sorted({ax for n in names for ax in self._leaf_axes(n)})
        return all_reduce_over(amax.clone(), axes, self.plan, "max")

    def row_max(self, name: str, amax: torch.Tensor) -> torch.Tensor:
        """``amax`` (a per-row max over the last dim of ``name``'s local
        shard) maxed over the axis that shards that last dim."""
        spec = self.specs[name]
        axes = [ax for ax in _axes(spec[-1]) if self.plan.shape[ax] > 1] \
            if spec else []
        return all_reduce_over(amax, axes, self.plan, "max") if axes \
            else amax

    def global_norm(self, names: Sequence[str],
                    grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum over leaves of each WHOLE leaf's float32 sum
        of squares: each shard's sum of squares summed over the axes
        that shard its leaf (a replicated leaf counted once), then the
        leaves summed in order, as ``optim.adamw.global_norm``."""
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
        by_axes: Dict[tuple, list] = {}
        for i, n in enumerate(names):
            by_axes.setdefault(self._leaf_axes(n), []).append(i)
        for axes, idx in by_axes.items():
            if not axes:
                continue
            part = all_reduce_over(torch.stack([sq[i] for i in idx]), axes,
                                   self.plan)
            for j, i in enumerate(idx):
                sq[i] = part[j]
        return torch.sqrt(torch.sum(torch.stack(sq)))


# ---------------------------------------------------------------------------
# Expert parallelism: the train step's mark and the dispatch's collectives
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class StepMark:
    """The sharded train step's mark: its ``plan`` and ``row_axes``, the
    mesh axes that split the batch's rows between ranks (``()`` when
    every rank holds every row)."""

    plan: MeshPlan
    row_axes: tuple

    @property
    def row_ranks(self) -> int:
        """Ranks that hold different rows (1: every rank holds all)."""
        return math.prod(self.plan.shape[a] for a in self.row_axes)


_STEP: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_train_step", default=None)


@contextlib.contextmanager
def train_step_mark(plan: MeshPlan, row_axes: Sequence[str]):
    """Mark the forward inside as the sharded train step's (see the
    module's docstring); :func:`active_step` reads it."""
    token = _STEP.set(StepMark(plan, tuple(row_axes)))
    try:
        yield
    finally:
        _STEP.reset(token)


def active_step() -> Optional[StepMark]:
    """The mark of :func:`train_step_mark`, or None."""
    return _STEP.get()


class _AllToAll(torch.autograd.Function):
    """(n, ...) -> (n, ...): chunk i of dim 0 goes to group rank i, and
    chunk j of the result came from group rank j. Its own inverse, so the
    backward sends the gradient back the same way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _exchange(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of ``t``'s contiguous chunks of dim 0. An
    int16 tensor travels as its bytes (neither gloo nor NCCL carries
    int16), and arrives as int16 again."""
    import torch.distributed as dist
    t = t.contiguous()
    wire = t.view(torch.int8) if t.dtype == torch.int16 else t
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return out.view(t.dtype)


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` (n, ...) exchanged over ``group`` of n ranks by contiguous
    chunks of dim 0, differentiable; ``t`` itself when ``group`` is None
    (an axis of one rank)."""
    return t if group is None else _AllToAll.apply(t, group)


def wire_all_to_all(t: torch.Tensor, group, bits: int) -> torch.Tensor:
    """:func:`all_to_all` of ``t`` (n, ..., D) on the reference's int8 /
    int16 wire (``_a2a``): each row over D quantized to ``bits`` with its
    float32 absmax scale (the absmax times the float32 reciprocal of
    qmax = 2^(bits-1) - 1, as XLA compiles the reference's division by
    the constant; at least 1e-12), rounded half to even and clipped; the
    integer payload and the scales travel as two all-to-alls and are
    multiplied back into ``t``'s dtype on arrival. With ``group`` None the
    quantize-dequantize alone (the reference applies its wire on an axis
    of one rank too). The backward is straight-through: the gradient
    goes back unquantized by the inverse all-to-all."""
    return _Wire.apply(t, group, bits)


def _wire_encode(t: torch.Tensor, bits: int):
    qmax = 2.0 ** (bits - 1) - 1.0
    amax = torch.amax(torch.abs(t), dim=-1, keepdim=True).to(torch.float32)
    scale = torch.clamp(amax * torch.full_like(amax, 1.0 / qmax), min=1e-12)
    q = torch.clamp(torch.round(t.to(torch.float32) / scale), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int16), scale


def _wire_decode(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


def wire_round_trip(t: torch.Tensor, bits: int) -> torch.Tensor:
    """``t`` through the wire's quantize-dequantize, without exchange."""
    return _wire_decode(*_wire_encode(t, bits), t.dtype)


class _Wire(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, bits):
        ctx.group = group
        q, scale = _wire_encode(t, bits)
        if group is not None:
            q, scale = _exchange(q, group), _exchange(scale, group)
        return _wire_decode(q, scale, t.dtype)

    @staticmethod
    def backward(ctx, grad):
        if ctx.group is not None:
            grad = _exchange(grad, ctx.group)
        return grad, None, None


class _SlicePiece(torch.autograd.Function):
    """Forward: this rank's piece of ``whole`` under ``spec``. Backward:
    the pieces' gradients gathered whole."""

    @staticmethod
    def forward(ctx, whole, spec, plan):
        ctx.spec, ctx.plan = spec, plan
        piece = local_shard(whole.detach(), spec, plan)
        # a view would alias the input: hand back storage of its own
        return piece.clone() if piece._base is not None else piece

    @staticmethod
    def backward(ctx, grad):
        return gather_whole(grad.contiguous(), ctx.spec, ctx.plan), None, None


def _dim_spec(t: torch.Tensor, dim: int, axes) -> tuple:
    spec = [None] * t.dim()
    spec[dim] = tuple(axes) if len(axes) > 1 else axes[0]
    return tuple(spec)


def gather_rows(piece: torch.Tensor, dim: int, axes: Sequence[str],
                plan: MeshPlan) -> torch.Tensor:
    """``piece`` all-gathered along ``dim`` over ``axes`` (major first);
    the backward hands each rank its own piece of the gradient, not a sum
    over the ranks (right when the gradient downstream is the same on
    every rank, or zero outside the rank's piece)."""
    axes = tuple(a for a in axes if plan.shape[a] > 1)
    if not axes:
        return piece
    return _GatherParam.apply(piece, _dim_spec(piece, dim, axes), (), plan)


def slice_rows(whole: torch.Tensor, dim: int, axes: Sequence[str],
               plan: MeshPlan) -> torch.Tensor:
    """This rank's piece of ``whole`` along ``dim`` over ``axes``; the
    backward gathers the pieces' gradients whole (the whole tensor was
    the same on every rank)."""
    axes = tuple(a for a in axes if plan.shape[a] > 1)
    if not axes:
        return whole
    return _SlicePiece.apply(whole, _dim_spec(whole, dim, axes), plan)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axes, plan):
        ctx.axes, ctx.plan = axes, plan
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_over(grad.contiguous().clone(), ctx.axes,
                               ctx.plan), None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def sum_grad(t: torch.Tensor, axes: Sequence[str], plan: MeshPlan
             ) -> torch.Tensor:
    """``t`` as it is; its gradient summed over ``axes``."""
    return _SumGrad.apply(t, tuple(axes), plan)


def scale_grad(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` as it is; its gradient divided by ``n``."""
    return _ScaleGrad.apply(t, n)
