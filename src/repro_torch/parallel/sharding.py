"""Logical-axis sharding rules (MaxText-style) -> DTensor placements per
port parameter, train-state leaf, batch leaf and cache leaf, the
reference's ``parallel/sharding.py`` over a ``torch.distributed``
``DeviceMesh``.

Mesh axes (``launch.mesh``): a serving replica's ``("data", "model")`` =
(world // tp, tp); the trainer's host mesh ``("data",)``; the
reference's production meshes (16, 16) and (2, 16, 16) exist here only
as :class:`AbstractMesh` layouts.

* Parameters: FSDP over "data" on the embed / reduction dim, TP over
  "model" on heads, ffn and vocab dims; ``inference=True`` strips the
  FSDP axis (serving keeps weights resident, replicated over "data").
* Train state: the moments and the wire's residuals mirror the
  parameters; an int8 moment's ``q`` shards like its parameter and its
  ``scale`` with the last dim replicated.
* Batches: dim 0 over ("pod", "data") when divisible, else "data" alone,
  else replicated.
* Dense caches: the batch dim over the data axes, heads over "model";
  paged KV pools: the KV-heads axis over "model", per-page scales
  replicated.

Every assignment is divisibility-checked: a dim the mesh axis does not
divide stays whole (hubert's vocab of 504). The rules match the
reference's tree paths and apply to the TRAILING dims of its stacked
leaves: a layer leaf there carries a leading period axis. The port
unstacks layers, so :func:`param_specs` and :func:`state_specs` rebuild
each leaf's reference path and stacked shape through
``models.transformer.reference_layout``, apply the reference's rule and
drop the period axis. Serving never shards a period axis. Training does
in one case: a per-layer 1-D leaf (a norm scale) is 2-D when stacked,
takes the generic 2-D rule, and so has its PERIOD axis over "data"; the
port's per-layer tensor cannot express that and is replicated over
"data" instead (D float32 values a layer a rank), its D over "model"
where the rule and divisibility allow, as the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Dict, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without devices or ranks: enough to
    lay out the reference's 256- and 512-device meshes on one host."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return self.axis_names


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or an
    :class:`AbstractMesh` (the reference's ``mesh.shape``)."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    mesh: object                    # DeviceMesh or AbstractMesh
    batch_axes: Tuple[str, ...]     # ("pod", "data") or ("data",)
    fsdp_axis: Optional[str]        # "data"
    model_axis: Optional[str]       # "model"

    @property
    def shape(self) -> Dict[str, int]:
        return axis_sizes(self.mesh)

    @property
    def batch_size_divisor(self) -> int:
        """Ranks over the batch axes together."""
        return math.prod(self.shape[a] for a in self.batch_axes)

    @property
    def model_size(self) -> int:
        """Ranks over the model axis (1 without one)."""
        return self.shape[self.model_axis] if self.model_axis else 1

    def model_group(self):
        """The process group of this rank's model axis (a ``DeviceMesh``
        only)."""
        return self.mesh.get_group(self.model_axis)


def plan_for_mesh(mesh) -> MeshPlan:
    names = tuple(mesh.mesh_dim_names)
    model = "model" if "model" in names else None
    if "pod" in names:
        return MeshPlan(mesh, ("pod", "data"), "data", model)
    if "data" in names:
        return MeshPlan(mesh, ("data",), "data", model)
    # single-axis test meshes
    return MeshPlan(mesh, (names[0],), None, None)


# ---------------------------------------------------------------------------
# Param rules: (path regex, logical axes for trailing dims), the
# reference's list. "fsdp" -> data, "tp" -> model, "ep" -> model (the
# expert dim), None -> whole.
# ---------------------------------------------------------------------------
_PARAM_RULES: Sequence[Tuple[str, Tuple[Optional[str], ...]]] = (
    (r"embed/table$",            ("fsdp", "tp")),
    (r"head/kernel$",            ("fsdp", "tp")),
    (r"(mixer|block)/w[qkv]$",   ("fsdp", "tp")),
    (r"(mixer|block)/b[qkv]$",   ("tp",)),
    (r"(mixer|block)/wo$",       ("tp", "fsdp")),
    (r"wq_a$",                   ("fsdp", "tp")),
    (r"wq_b$",                   ("fsdp", "tp")),
    (r"wkv_a$",                  ("fsdp", "tp")),
    (r"wkv_b$",                  ("fsdp", "tp")),
    (r"ffn/router$",             ("fsdp", None)),
    # routed experts: EP over model x ZeRO-3 over data on the F dim
    (r"experts/w_gate$",         ("ep", None, "fsdp")),
    (r"experts/w_up$",           ("ep", None, "fsdp")),
    (r"experts/w_down$",         ("ep", "fsdp", None)),
    # shared expert / dense mlp (2-D)
    (r"(shared|ffn)/w_gate$",    ("fsdp", "tp")),
    (r"(shared|ffn)/w_up$",      ("fsdp", "tp")),
    (r"(shared|ffn)/w_down$",    ("tp", "fsdp")),
    (r"ffn/w_in$",               ("fsdp", "tp")),
    (r"ffn/w_out$",              ("tp", "fsdp")),
    (r"ffn/b_in$",               ("tp",)),
    (r"ffn/b_out$",              (None,)),
    # SSM / recurrent
    (r"mixer/in_proj$",          ("fsdp", "tp")),
    (r"mixer/out_proj$",         ("tp", "fsdp")),
    (r"mixer/up_proj$",          ("fsdp", "tp")),
    (r"mixer/down_proj$",        ("tp", "fsdp")),
    (r"mixer/conv_w$",           (None, "tp")),
    (r"mixer/w_[if]$",           ("fsdp", None)),
    (r"mixer/r$",                (None, None, "tp")),
    (r"mixer/w_in$",             ("fsdp", "tp")),
    (r"mtp/proj$",               ("fsdp", "tp")),
)


def _leaf_path_str(path) -> str:
    """A reference tree path (keys and list indices) as "a/0/b"."""
    return "/".join(str(p) for p in path)


@functools.lru_cache(maxsize=4096)
def _rule(path_str: str):
    """The logical axes of the first rule matching ``path_str``, or
    None (a reference path, as "segments/0/1/mixer/wq")."""
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path_str):
            return axes
    return None


def _spec_for_leaf(path_str: str, shape, plan: MeshPlan,
                   *, inference: bool = False) -> Tuple[Optional[str], ...]:
    """The reference's PartitionSpec (a tuple of mesh axis names or None,
    one per dim) of the leaf at ``path_str`` with the reference's
    ``shape`` (stacked leaves carry their period axis)."""
    ndim = len(shape)
    trailing = _rule(path_str)
    if trailing is None:
        # generic fallback: 2-D+ leaves get FSDP x TP, 1-D replicated
        trailing = ("fsdp", "tp") if ndim >= 2 else (None,)
    if inference:
        # serving: weights TP-only, replicated over "data"
        trailing = tuple(None if t == "fsdp" else t for t in trailing)
    k = min(len(trailing), ndim)
    trailing = trailing[-k:]
    lead = ndim - k
    spec = [None] * lead
    used = set()
    sizes = plan.shape
    for dim_axis, logical in zip(range(lead, ndim), trailing):
        if logical is None:
            spec.append(None)
            continue
        mesh_axis = (plan.fsdp_axis if logical == "fsdp" else plan.model_axis)
        if mesh_axis is None or mesh_axis in used:
            spec.append(None)
            continue
        if shape[dim_axis] % sizes[mesh_axis] != 0:
            spec.append(None)   # divisibility fallback: this dim stays whole
            continue
        used.add(mesh_axis)
        spec.append(mesh_axis)
    return tuple(spec)


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, an axis, or a tuple of axes
    major first, as the batch dim's ("pod", "data"))."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec, plan: MeshPlan) -> tuple:
    """A per-dim spec as DTensor placements, one per mesh axis in the
    mesh's order: ``Shard(d)`` on each axis that shards dim d, else
    ``Replicate()``."""
    out = []
    for ax in plan.mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if ax in _axes(a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _layer_periods(layout) -> Dict[tuple, int]:
    periods: Dict[tuple, int] = {}
    for _, path, p in layout:
        if p is not None:
            periods[path] = periods.get(path, 0) + 1
    return periods


def _port_spec(path_str: str, shape, periods: Optional[int],
               plan: MeshPlan, *, inference: bool = False) -> tuple:
    """The reference's spec of a leaf of the port's ``shape`` at
    ``path_str``: a layer leaf (``periods`` given) is laid out stacked,
    then its period axis is dropped (replicated over an axis that shards
    it: the norm-scale decision, see the module's docstring)."""
    if periods is None:
        return _spec_for_leaf(path_str, shape, plan, inference=inference)
    return _spec_for_leaf(path_str, (periods,) + tuple(shape), plan,
                          inference=inference)[1:]


def param_specs(model, cfg, plan: MeshPlan, *, inference: bool = False
                ) -> Dict[str, Tuple[Optional[str], ...]]:
    """{parameter name: per-dim spec of the port's tensor}: the
    reference's spec of the same leaf (its path and stacked shape from
    ``reference_layout``), its period axis dropped for a layer leaf.
    ``inference=True``: the serving placements (TP only). ``model`` holds
    the parameters' global shapes (a model on the meta device will
    do)."""
    from ..models.transformer import reference_layout
    params = dict(model.named_parameters())
    layout = reference_layout(model, cfg)
    periods = _layer_periods(layout)
    return {name: _port_spec(_leaf_path_str(path), tuple(params[name].shape),
                             None if p is None else periods[path], plan,
                             inference=inference)
            for name, path, p in layout}


def param_shardings(model, cfg, plan: MeshPlan, *, inference: bool = False
                    ) -> Dict[str, tuple]:
    """{parameter name: DTensor placements} (see :func:`param_specs`).
    ``inference=True`` = TP-only, no FSDP axis."""
    return {n: placements(s, plan)
            for n, s in param_specs(model, cfg, plan,
                                    inference=inference).items()}


def _state_path(path_str: str) -> str:
    """The reference's path quirks in ``state_shardings``: an int8
    moment's ``/q`` and ``/scale`` are stripped to the parameter's path,
    but a path ending in ``norm/scale`` keeps its ``/scale``."""
    if path_str.endswith("/q"):
        return path_str[:-2]
    if path_str.endswith("/scale") and not path_str.endswith("norm/scale"):
        return path_str[:-6]
    return path_str


def state_specs(state, cfg, plan: MeshPlan) -> dict:
    """Per-dim specs of a train state (``launch.steps.init_train_state``'s
    ``{"params": model, "opt": {"step", "m", "v"}, "ef_residual"}``) in
    its own layout: ``params`` and ``ef_residual`` {name: spec}, ``opt``
    {"step": (), "m" / "v": {name: spec, or {"q": spec, "scale": spec}
    for int8 moments}}. Each leaf's spec is the reference's
    ``state_shardings`` of the same leaf of its tree (``params/<path>``,
    ``opt/m/<path>[/q|/scale]``, ``ef_residual/<path>``, the path quirks
    kept), its period axis dropped. ``state`` holds global shapes (a
    template on the meta device will do)."""
    from ..models.transformer import reference_layout
    model = state["params"]
    layout = reference_layout(model, cfg)
    periods = _layer_periods(layout)
    where = {name: (_leaf_path_str(path),
                    None if p is None else periods[path])
             for name, path, p in layout}

    def leaf(prefix, name, t, suffix=""):
        path, n = where[name]
        return _port_spec(_state_path(f"{prefix}/{path}{suffix}"),
                          tuple(t.shape), n, plan)

    def tree(prefix, values):
        out = {}
        for name, v in values.items():
            if isinstance(v, dict):
                out[name] = {k: leaf(prefix, name, x, f"/{k}")
                             for k, x in v.items()}
            else:
                out[name] = leaf(prefix, name, v)
        return out

    out = {"params": tree("params", dict(model.named_parameters())),
           "opt": {"step": (), "m": tree("opt/m", state["opt"]["m"]),
                   "v": tree("opt/v", state["opt"]["v"])}}
    if "ef_residual" in state:
        out["ef_residual"] = tree("ef_residual", state["ef_residual"])
    return out


def _map_specs(fn, specs):
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    return fn(specs)


def state_shardings(state, cfg, plan: MeshPlan) -> dict:
    """:func:`state_specs` as DTensor placements."""
    return _map_specs(lambda s: placements(s, plan),
                      state_specs(state, cfg, plan))


# ---------------------------------------------------------------------------
# Batch / activation shardings
# ---------------------------------------------------------------------------
def _batch_axes_for(plan: MeshPlan, size: int):
    """The batch axes that divide ``size``: all of them (a tuple when
    there are several, else the one axis), else the inner ("data") axis
    alone, else the outer, else None (replicated)."""
    sizes = plan.shape
    if size % plan.batch_size_divisor == 0:
        return (plan.batch_axes if len(plan.batch_axes) > 1
                else plan.batch_axes[0])
    for ax in plan.batch_axes[::-1]:
        if size % sizes[ax] == 0:
            return ax
    return None


def auto_batch_specs(batch, plan: MeshPlan) -> dict:
    """{key: per-dim spec} of a batch dict: dim 0 (the batch) over the
    data axes by :func:`_batch_axes_for`, every other dim whole; a scalar
    replicated. For tokens, labels, masks, embeddings and positions."""
    out = {}
    for k, v in batch.items():
        shape = tuple(getattr(v, "shape", ()))
        if not shape:
            out[k] = ()
            continue
        out[k] = (_batch_axes_for(plan, shape[0]),) + (None,) * (
            len(shape) - 1)
    return out


def auto_batch_sharding(batch, plan: MeshPlan) -> dict:
    """:func:`auto_batch_specs` as DTensor placements."""
    return {k: placements(s, plan)
            for k, s in auto_batch_specs(batch, plan).items()}


class BatchShard(dict):
    """This rank's rows of a global batch (a dict of its leaves) and
    ``axes``, the mesh axes that shard dim 0 (a spec entry: None when
    every rank holds every row)."""

    def __init__(self, leaves, axes):
        super().__init__(leaves)
        self.axes = axes


def shard_batch(batch, plan: MeshPlan) -> BatchShard:
    """This rank's rows of the global ``batch`` under ``plan``
    (:func:`auto_batch_specs`)."""
    if isinstance(batch, BatchShard):
        return batch
    specs = auto_batch_specs(batch, plan)
    axes = next((s[0] for s in specs.values() if s), None)
    return BatchShard({k: local_shard(v, specs[k], plan) if specs[k] else v
                       for k, v in batch.items()}, axes)


_STATE_KEYS = {"ssm", "C", "h", "c", "n", "m"}


def cache_specs(caches, plan: MeshPlan) -> list:
    """Per-dim specs of DENSE caches (``init_cache`` without a paged
    spec): one dict a layer, each leaf laid out as the reference's
    ``cache_shardings`` lays out its stacked leaf, the leading period
    axis dropped:

      kv     : (B, T, KV, hd)    -> batch dp, KV over model (fallback: hd)
      latent : (B, T, W)         -> batch dp, W over model
      ssm    : (B, nh, N, P)     -> batch dp, nh over model (fallback: N/P)
      conv   : (B, k-1, di)      -> batch dp, di over model
      mlstm C: (B, nh, dk, dv+1) -> batch dp, nh over model (fallback: dk)
      m/n/h  : (B, nh[, hd])     -> batch dp, nh over model

    The batch dim over the data axes (divisibility-checked), then the
    first dim from index 2 on that "model" divides (a recurrent state's
    from index 1: it has no time dim), the time dim last; a 0-dim leaf
    replicated."""
    model = plan.model_axis
    msize = plan.model_size

    def leaf(key, shape):
        ndim = len(shape)
        if ndim == 0:
            return ()
        spec = [None] * ndim
        spec[0] = _batch_axes_for(plan, shape[0])
        if model is not None:
            cand = (list(range(1, ndim)) if key in _STATE_KEYS
                    else list(range(2, ndim)) + ([1] if ndim > 1 else []))
            for i in cand:
                if spec[i] is None and shape[i] % msize == 0 \
                        and shape[i] >= msize:
                    spec[i] = model
                    break
        return tuple(spec)

    return [{k: leaf(k, tuple(t.shape)) for k, t in layer.items()}
            for layer in caches]


def cache_shardings(caches, plan: MeshPlan) -> list:
    """:func:`cache_specs` as DTensor placements."""
    return [{k: placements(s, plan) for k, s in layer.items()}
            for layer in cache_specs(caches, plan)]


def paged_pool_specs(caches, plan: MeshPlan) -> list:
    """Per-dim specs of a PAGED serving cache (``init_cache`` with a
    ``PagedCacheSpec``): one dict a layer. A pool's page grids ``(NP, ps,
    KV, hdw)`` shard the KV-heads axis (ndim - 2) over "model": int4
    lane packing runs along head_dim, so a head shard keeps each page's
    packed words whole, and a page's bytes per head stay on their rank,
    so host extract / inject round trips stay byte-exact per shard.
    Nothing shards over the data axes (pages are shared by every slot).
    Per-page scales ``(NP,)`` and every other leaf (a recurrent layer's
    state) replicate; a head count the axis does not divide stays whole."""
    model = plan.model_axis
    msize = plan.model_size

    def leaf(key, shape):
        spec = [None] * len(shape)
        if key in ("k_pages", "v_pages") and len(shape) >= 4 \
                and model is not None and shape[-2] % msize == 0 \
                and shape[-2] >= msize:
            spec[len(shape) - 2] = model
        return tuple(spec)

    return [{k: leaf(k, tuple(t.shape)) for k, t in layer.items()}
            for layer in caches]


def paged_pool_shardings(caches, plan: MeshPlan) -> list:
    """:func:`paged_pool_specs` as DTensor placements."""
    return [{k: placements(s, plan) for k, s in layer.items()}
            for layer in paged_pool_specs(caches, plan)]


# ---------------------------------------------------------------------------
# Local shards
# ---------------------------------------------------------------------------
def local_shard(t, spec, plan: MeshPlan):
    """This rank's shard of the full tensor ``t`` under ``spec`` (a view
    when the shard is contiguous). A dim over several axes splits major
    axis first, as the reference's ("pod", "data")."""
    sizes = plan.shape
    coords = dict(zip(plan.mesh.mesh_dim_names, plan.mesh.get_coordinate()))
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        idx, n = 0, t.shape[d]
        for ax in axes:
            n //= sizes[ax]
            idx = idx * sizes[ax] + coords[ax]
        t = t.narrow(d, idx * n, n)
    return t if t.is_contiguous() else t.contiguous()


def gather_whole(t, spec, plan: MeshPlan):
    """The whole tensor of which ``t`` is this rank's shard under ``spec``
    (all-gathers over each sharding axis; no autograd). Every rank of the
    mesh must call it, in the same order."""
    import torch
    import torch.distributed as dist
    sizes = plan.shape
    for d, entry in enumerate(spec):
        for ax in reversed(_axes(entry)):      # inner axis first
            if sizes[ax] == 1:
                continue
            group = plan.mesh.get_group(ax)
            parts = [torch.empty_like(t) for _ in range(sizes[ax])]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=d)
    return t
