"""Collective bytes, memory and aggregate cost of one eager step: the
summaries of the reference's ``launch/hlo_analysis.py``.

The reference parses the SPMD-partitioned HLO text of a compiled step.
This port has no compiler and no HLO: it counts the aten and c10d ops
that an eager step dispatches, as ``launch.hlo_cost.OpCostRecorder``
records them (under ``FakeTensorMode`` in the dry run). A rank's tensors
are its own shards, so every figure is PER RANK, as the reference's are
per device. Each collective is one ``c10d`` op; its group's size comes
from the op's process group, and its ring-model WIRE bytes per rank
follow the reference's factors:

    all-gather          (g-1)/g x output bytes      (received)
    all-reduce          2 (g-1)/g x operand bytes   (RS + AG rings)
    reduce-scatter      (g-1)/g x operand bytes
    all-to-all          (g-1)/g x operand bytes
    collective-permute  1.0     x operand bytes     (one hop: send/recv)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_RING_FACTOR = {
    "all-gather": lambda g: (g - 1) / g,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

# c10d op name -> (collective type, index of its output argument, index of
# its operand argument); None: the op has no such argument (a send
# receives nothing, a receive sends nothing)
_C10D = {
    "allreduce_": ("all-reduce", 0, 0),
    "allreduce_coalesced_": ("all-reduce", 0, 0),
    "allgather_": ("all-gather", 0, 1),
    "_allgather_base_": ("all-gather", 0, 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 1),
    "reduce_scatter_": ("reduce-scatter", 0, 1),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 1),
    "alltoall_": ("all-to-all", 0, 1),
    "alltoall_base_": ("all-to-all", 0, 1),
    "send": ("collective-permute", None, 0),
    "recv_": ("collective-permute", 0, None),
}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes an op moves reading or writing ``t``: its elements, or its
    storage where that is smaller (an expanded view reads its storage
    once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def tree_bytes(x) -> int:
    """:func:`tensor_bytes` summed over the tensors of a nest of lists and
    tuples."""
    if isinstance(x, torch.Tensor):
        return tensor_bytes(x)
    if isinstance(x, (list, tuple)):
        return sum(tree_bytes(v) for v in x)
    return 0


@dataclasses.dataclass
class CollectiveOp:
    opcode: str
    name: str
    output_bytes: int
    operand_bytes: int
    group_size: int
    wire_bytes: float  # ring-model per-rank wire bytes


def collective_op(func, args) -> Optional[CollectiveOp]:
    """The :class:`CollectiveOp` of a dispatched ``c10d`` op and its
    arguments, or None for a c10d op that moves no data (a barrier, a
    wait). Raises ``KeyError`` for a data-moving c10d op this table does
    not know, so no collective goes uncounted."""
    name = func._schema.name.split("::")[-1]
    if name in ("barrier", "monitored_barrier_", "wait_tensor"):
        return None
    base, out_i, in_i = _C10D[name]
    out_b = tree_bytes(args[out_i]) if out_i is not None else 0
    op_b = tree_bytes(args[in_i]) if in_i is not None else 0
    if base == "collective-permute":
        op_b = op_b or out_b
    group = next(a for a in args if isinstance(a, torch.ScriptObject))
    import torch.distributed as dist
    g = dist.ProcessGroup.unbox(group).size()
    wire = _RING_FACTOR[base](max(g, 1)) * (
        out_b if base == "all-gather" else op_b)
    return CollectiveOp(base, name, out_b, op_b, g, wire)


def collective_summary(ops: List[CollectiveOp]) -> dict:
    """The reference's per-type summary of a step's collectives:
    ``per_type`` {type: count, operand_bytes, output_bytes, wire_bytes},
    ``total_operand_bytes``, ``total_wire_bytes_per_device`` (per rank
    here) and ``count``."""
    by_type: Dict[str, dict] = {}
    for op in ops:
        d = by_type.setdefault(op.opcode, {"count": 0, "operand_bytes": 0,
                                           "output_bytes": 0,
                                           "wire_bytes": 0.0})
        d["count"] += 1
        d["operand_bytes"] += op.operand_bytes
        d["output_bytes"] += op.output_bytes
        d["wire_bytes"] += op.wire_bytes
    return {
        "per_type": by_type,
        "total_operand_bytes": sum(o.operand_bytes for o in ops),
        "total_wire_bytes_per_device": sum(o.wire_bytes for o in ops),
        "count": len(ops),
    }


def memory_summary(rec) -> dict:
    """The reference's memory keys from a recorder's storage tracking
    (``launch.hlo_cost.OpCostRecorder``), per rank: the step's arguments
    (its state, batch or caches), its new outputs, its transients above
    both at the peak, the outputs that are arguments updated in place,
    and the peak of live bytes. Eager code has no generated code."""
    mem = rec.memory
    return {"argument_size_in_bytes": mem["argument"],
            "output_size_in_bytes": mem["output"],
            "temp_size_in_bytes": max(mem["peak"] - mem["argument"]
                                      - mem["output"], 0),
            "alias_size_in_bytes": mem["alias"],
            "peak_memory_in_bytes": mem["peak"],
            "generated_code_size_in_bytes": 0}


def cost_summary(rec) -> dict:
    """The reference's aggregate-cost keys from a recorder: FLOPs, bytes
    accessed and transcendental elements of every dispatched op (an eager
    loop dispatches each trip, so there is no once-per-body count to
    report beside the loop-aware one)."""
    c = rec.total
    return {"flops": float(c.flops), "bytes_accessed": float(c.hbm_bytes),
            "transcendentals": float(rec.transcendentals)}
