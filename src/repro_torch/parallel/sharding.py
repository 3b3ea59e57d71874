"""Logical-axis sharding rules (MaxText-style) -> DTensor placements per
port parameter and paged-pool leaf, the reference's
``parallel/sharding.py`` over a ``torch.distributed`` ``DeviceMesh``.

Mesh axes (``launch.mesh``): a serving replica's ``("data", "model")`` =
(world // tp, tp); the reference's production meshes (16, 16) and
(2, 16, 16) exist here only as :class:`AbstractMesh` layouts.

* Parameters: FSDP over "data" on the embed / reduction dim, TP over
  "model" on heads, ffn and vocab dims; ``inference=True`` strips the
  FSDP axis (serving keeps weights resident, replicated over "data").
* Paged KV pools: the KV-heads axis over "model"; per-page scales
  replicate.

Every assignment is divisibility-checked: a dim the mesh axis does not
divide stays whole (hubert's vocab of 504). The rules match the
reference's tree paths and apply to the TRAILING dims of its stacked
leaves: a layer leaf there carries a leading period axis, which the
serving rules never shard. The port unstacks layers, so
:func:`param_specs` rebuilds each
parameter's reference path and stacked shape through
``models.transformer.reference_layout`` before it applies them: a
layer's norm scale is 2-D in the reference's tree (periods, D) and takes
the generic 2-D rule, as it does there.

``state_shardings``, ``cache_shardings`` and ``auto_batch_sharding``
(training and dense caches) come with distributed training, ROADMAP
queue A item 13.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard

_ITEM_13 = "is not ported yet: ROADMAP queue A item 13"


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


def _spec_for_leaf(path_str: str, shape, plan: MeshPlan,
                   *, inference: bool = False) -> Tuple[Optional[str], ...]:
    """The reference's PartitionSpec (a tuple of mesh axis names or None,
    one per dim) of the leaf at ``path_str`` with the reference's
    ``shape`` (stacked leaves carry their period axis)."""
    ndim = len(shape)
    trailing = None
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path_str):
            trailing = axes
            break
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


def placements(spec, plan: MeshPlan) -> tuple:
    """A per-dim spec as DTensor placements, one per mesh axis in the
    mesh's order: ``Shard(d)`` on the axis that shards dim d, else
    ``Replicate()``."""
    out = []
    for ax in plan.mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec) if a == ax]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_specs(model, cfg, plan: MeshPlan, *, inference: bool = False
                ) -> Dict[str, Tuple[Optional[str], ...]]:
    """{parameter name: per-dim spec of the port's tensor}: the
    reference's spec of the same leaf (its path and stacked shape from
    ``reference_layout``), its period axis dropped for a layer leaf.

    Serving placements only (``inference=True``): the training rules
    shard a stacked norm scale's period axis over "data" (the generic 2-D
    rule takes it for a trailing dim), which unstacked layers cannot
    express; training placements come with ROADMAP queue A item 13."""
    if not inference:
        raise NotImplementedError(f"training placements (inference=False) "
                                  f"{_ITEM_13}")
    from ..models.transformer import reference_layout
    params = dict(model.named_parameters())
    layout = reference_layout(model, cfg)
    periods: Dict[tuple, int] = {}
    for _, path, p in layout:
        if p is not None:
            periods[path] = periods.get(path, 0) + 1
    out = {}
    for name, path, p in layout:
        shape = tuple(params[name].shape)
        if p is None:
            out[name] = _spec_for_leaf(_leaf_path_str(path), shape, plan,
                                       inference=inference)
        else:
            spec = _spec_for_leaf(_leaf_path_str(path),
                                  (periods[path],) + shape, plan,
                                  inference=inference)
            assert spec[0] is None      # serving never shards a period
            out[name] = spec[1:]
    return out


def param_shardings(model, cfg, plan: MeshPlan, *, inference: bool = False
                    ) -> Dict[str, tuple]:
    """{parameter name: DTensor placements} (see :func:`param_specs`).
    ``inference=True`` = TP-only, no FSDP axis."""
    return {n: placements(s, plan)
            for n, s in param_specs(model, cfg, plan,
                                    inference=inference).items()}


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


def local_shard(t, spec, plan: MeshPlan):
    """This rank's shard of the full tensor ``t`` under ``spec`` (a view
    when the shard is contiguous)."""
    sizes = plan.shape
    coords = dict(zip(plan.mesh.mesh_dim_names,
                      plan.mesh.get_coordinate()))
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        n = t.shape[d] // sizes[ax]
        t = t.narrow(d, coords[ax] * n, n)
    return t if t.is_contiguous() else t.contiguous()


def state_shardings(*args, **kwargs):
    """The train state's shardings come with distributed training."""
    raise NotImplementedError(f"state_shardings {_ITEM_13}")


def cache_shardings(*args, **kwargs):
    """Dense KV / state cache shardings come with distributed training."""
    raise NotImplementedError(f"cache_shardings {_ITEM_13}")


def auto_batch_sharding(*args, **kwargs):
    """Input batch shardings come with distributed training."""
    raise NotImplementedError(f"auto_batch_sharding {_ITEM_13}")
