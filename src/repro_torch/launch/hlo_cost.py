"""The op-level cost recorder: the loop-aware cost model of the
reference's ``launch/hlo_cost.py`` for an eager step.

The reference parses optimized HLO text and multiplies each ``while``
body by its trip count. This port has no HLO: :class:`OpCostRecorder` is
a ``TorchDispatchMode`` that counts the aten and c10d ops an eager step
dispatches, run over the step under ``FakeTensorMode`` in the dry run
(``launch.dryrun``) or over a real step. A rank's tensors are its own
shards, so every figure is per rank and per step:

  * flops      - ``torch.utils.flop_counter``'s formulas (a dot's over its
                 contracting dims; an op without a formula is
                 decomposed where it can be, as ``FlopCounterMode`` does)
  * hbm_bytes  - every eager op is one launch, so it is this port's
                 fusion boundary: an op costs its input plus its output
                 bytes; views and metadata ops are free; slicing,
                 indexing and gathers are priced at the slice, not the
                 source (the reference's ``_READ_SLICE``); an in-place
                 scatter or ``index_put_`` at the update (its
                 ``_ALIASED_WRITE``)
  * wire_bytes - each ``c10d`` collective times its group's ring factor
                 (``launch.hlo_analysis``)
  * memory     - live bytes of tensor storages, each counted once across
                 its views and freed with its last reference; autograd's
                 saved tensors stay live while the graph holds them

Loops cost nothing extra to count: an eager Python loop dispatches every
trip. :meth:`OpCostRecorder.loop` marks one for the ``loops`` report, and
a model's layer segments (``configs.counting.layer_segments``) report as
one loop each, trip = the segment's periods, the counterpart of the
reference's scan over periods (``models.common.enter_layer`` tells the
recorder which layer runs, in the forward and in the backward). A
``torch.cond`` is priced at its dearer branch, as the reference prices a
conditional: both branches run under the recorder.

The CUDA kernels of ``kernels/`` launch through ``ctypes`` and are
invisible to a dispatch mode; a fake tensor reaching one raises
(``kernels.build.refuse_fake``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..models.common import LAYER_LISTENER
from .hlo_analysis import collective_op, tensor_bytes

_ATEN = torch.ops.aten

# slicing ops read only the slice (+ indices), not the whole source
_READ_SLICE = {_ATEN.index, _ATEN.index_select, _ATEN.gather,
               _ATEN.embedding, _ATEN.take_along_dim}
# in-place window writes cost the update (+ indices): the buffer aliases
_ALIASED_WRITE = {_ATEN.index_put_, _ATEN._index_put_impl_, _ATEN.scatter_,
                  _ATEN.scatter_add_, _ATEN.scatter_reduce_,
                  _ATEN.index_add_, _ATEN.index_copy_,
                  _ATEN.masked_scatter_}
# in-place writes that do not read what they overwrite
_WRITE_ONLY = {_ATEN.copy_, _ATEN.fill_, _ATEN.zero_, _ATEN.normal_,
               _ATEN.uniform_}
# ops that allocate without writing, or only read metadata
# (``_unsafe_view``: the view that ends an eager ``reshape`` of a copy)
_FREE = {_ATEN.empty, _ATEN.empty_like, _ATEN.empty_strided,
         _ATEN.new_empty, _ATEN.new_empty_strided, _ATEN.lift_fresh,
         _ATEN.set_, _ATEN.resize_, _ATEN._unsafe_view}
_TRANSCENDENTAL = {_ATEN.exp, _ATEN.exp2, _ATEN.expm1, _ATEN.log,
                   _ATEN.log1p, _ATEN.log2, _ATEN.tanh, _ATEN.sigmoid,
                   _ATEN.sin, _ATEN.cos, _ATEN.rsqrt, _ATEN.sqrt,
                   _ATEN.erf, _ATEN.silu, _ATEN.gelu, _ATEN.softplus,
                   _ATEN._softmax, _ATEN._log_softmax, _ATEN.pow,
                   _ATEN.log_sigmoid_forward}
_CUDA_BLOCK = 512      # the caching allocator rounds a block up to this


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    wire_bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __iadd__(self, o: "Cost"):
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        self.wire_bytes += o.wire_bytes
        for k, v in o.coll.items():
            self.coll[k] = self.coll.get(k, 0.0) + v
        return self

    def scaled(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.hbm_bytes * m, self.wire_bytes * m,
                    {k: v * m for k, v in self.coll.items()})


def _tensors(x, out=None) -> list:
    """The tensors of a nest of lists, tuples and dicts (an op's
    arguments or results), in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


_DECOMPOSES: Dict[object, bool] = {}


def _decomposes(func) -> bool:
    """Whether ``func`` has a composite kernel to decompose into."""
    got = _DECOMPOSES.get(func)
    if got is None:
        got = _DECOMPOSES[func] = \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd")
    return got


def _storage_bytes(t: torch.Tensor) -> int:
    n = t.untyped_storage().nbytes()
    if t.device.type == "cuda":
        n = -(-n // _CUDA_BLOCK) * _CUDA_BLOCK
    return n


class _Loop:
    """One marked loop's running account."""

    def __init__(self, name, where, trip, carry_bytes=0):
        self.name, self.where, self.trip = name, where, trip
        self.carry_bytes = carry_bytes
        self.cost = Cost()

    def entry(self) -> dict:
        body = self.cost.scaled(1.0 / max(self.trip, 1))
        return {"name": self.name, "in": self.where, "trip": self.trip,
                "carry_bytes": self.carry_bytes,
                "body_flops": body.flops,
                "body_hbm_bytes": body.hbm_bytes,
                "body_wire_bytes": body.wire_bytes,
                "total_hbm_bytes": body.hbm_bytes * self.trip}


class OpCostRecorder(TorchDispatchMode):
    """Count the cost of every op dispatched while the recorder is
    entered (see the module's docstring). ``cfg``: a model config whose
    layer segments report as loops. :meth:`track` the step's arguments
    before running it and :meth:`outputs` its results after, for the
    memory figures; :func:`analyze` reports."""

    supports_higher_order_operators = True

    def __init__(self, cfg=None):
        super().__init__()
        self.total = Cost()
        self.transcendentals = 0.0
        self.collectives = []
        self.warnings: List[str] = []
        self.by_op: Dict[str, dict] = {}
        self._loops: List[_Loop] = []          # open marked loops
        self._done: Dict[tuple, _Loop] = {}    # first run of each loop
        self._segment_of: Dict[int, int] = {}
        self._segments: List[_Loop] = []
        if cfg is not None:
            from ..configs.counting import layer_segments, segment_layers
            for si, (_, periods, _) in enumerate(layer_segments(cfg)):
                self._segments.append(_Loop(f"segments/{si}", "step",
                                            periods))
            for li, si, _, _ in segment_layers(cfg):
                self._segment_of[li] = si
        self._layer: Optional[int] = None
        self._last: Optional[int] = None
        self._listen_token = None
        self._depth = 0
        # storage key -> bytes, of every live tracked storage
        self._live: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._args: Dict[int, int] = {}
        self.live_bytes = 0
        self.memory = {"argument": 0, "output": 0, "alias": 0, "peak": 0}

    # -- entry and exit --------------------------------------------------
    def __enter__(self):
        if self._depth == 0:
            self._listen_token = LAYER_LISTENER.set(self._enter_layer)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            LAYER_LISTENER.reset(self._listen_token)
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------
    def _see(self, t: torch.Tensor, *, since: str = "new") -> None:
        """Count ``t``'s storage live from now (``since`` "new": an op's
        output), or from the step's start: "argument" (a tracked input)
        or "host" (a tensor made outside the dispatch, as from numpy, first
        read here), both part of every earlier peak."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = _storage_bytes(t)
        self._live[key] = n
        self.live_bytes += n
        if since != "new":
            self.memory["peak"] += n
        if since == "argument":
            self._args[key] = n
            self.memory["argument"] += n
        self.memory["peak"] = max(self.memory["peak"], self.live_bytes)

        def gone(_, key=key, rec=weakref.ref(self)):
            r = rec()
            if r is not None:
                r.live_bytes -= r._live.pop(key, 0)
                r._refs.pop(key, None)
                r._args.pop(key, None)

        self._refs[key] = weakref.ref(st, gone)

    def track(self, *trees) -> None:
        """Count the tensors of ``trees`` (the step's arguments: a model's
        parameters, a state, a batch, caches) as live from the start."""
        for t in tree_leaves(trees):
            if isinstance(t, torch.nn.Module):
                for p in t.parameters():
                    self._see(p, since="argument")
            elif isinstance(t, torch.Tensor):
                self._see(t, since="argument")

    def outputs(self, *trees) -> None:
        """Account the step's results: a tensor on an argument's storage
        (a state or cache updated in place) is an alias, any other a new
        output."""
        seen = set()
        for t in tree_leaves(trees):
            if isinstance(t, torch.nn.Module):
                ts = list(t.parameters())
            elif isinstance(t, torch.Tensor):
                ts = [t]
            else:
                continue
            for x in ts:
                key = x.untyped_storage()._cdata
                if key in seen:
                    continue
                seen.add(key)
                n = _storage_bytes(x)
                self.memory["alias" if key in self._args else "output"] += n

    # -- layers and loops --------------------------------------------------
    def _enter_layer(self, x, li):
        prev = None if li == 0 else self._last
        if x.requires_grad:
            def back(_, prev=prev):
                self._layer = prev

            x.register_hook(back)
        if li is not None and li in self._segment_of:
            seg = self._segments[self._segment_of[li]]
            if not seg.carry_bytes:
                seg.carry_bytes = tensor_bytes(x)
        self._layer = li
        if li is not None:
            self._last = li
        return x

    @contextlib.contextmanager
    def loop(self, name: str, trip: int):
        """Mark a Python loop of ``trip`` trips run inside: the ``loops``
        report gets one entry a loop (the first time each is run under its
        enclosing loop), its body the average trip."""
        where = self._loops[-1].name if self._loops else "step"
        lp = _Loop(name, where, trip)
        self._loops.append(lp)
        try:
            yield
        finally:
            self._loops.pop()
            self._done.setdefault((where, name), lp)

    def loops(self) -> List[dict]:
        out = [lp.entry() for lp in self._done.values()]
        out += [seg.entry() for seg in self._segments]
        return sorted(out, key=lambda d: -d["total_hbm_bytes"])

    # -- pricing -----------------------------------------------------------
    def _add(self, key, c: Cost) -> None:
        self.total += c
        for lp in self._loops:
            lp.cost += c
        if self._layer is not None and self._layer in self._segment_of:
            self._segments[self._segment_of[self._layer]].cost += c
        d = self.by_op.get(key)
        if d is None:
            d = self.by_op[key] = {"op": str(key), "count": 0,
                                   "flops": 0.0, "bytes": 0.0,
                                   "wire_bytes": 0.0}
        d["count"] += 1
        d["flops"] += c.flops
        d["bytes"] += c.hbm_bytes
        d["wire_bytes"] += c.wire_bytes

    def _bytes(self, func, ins, outs) -> float:
        packet = func.overloadpacket
        if not outs or func.is_view or packet in _FREE:
            return 0.0          # a view, an allocation, a metadata query
        ins = [tensor_bytes(t) for t in ins]
        out_b = sum(tensor_bytes(t) for t in outs)
        big = max(ins, default=0)
        if packet in _READ_SLICE and ins:
            return float(sum(ins) - big + out_b)
        if packet in _ALIASED_WRITE and ins:
            return float(sum(ins) - big + max(out_b - big, 0))
        if packet in _WRITE_ONLY:
            return float(sum(ins) - ins[0] + out_b)
        return float(sum(ins) + out_b)

    def _cond(self, args, kwargs):
        """``torch.cond``: both branches run under the recorder, each
        priced apart; the dearer is kept (FLOPs plus bytes, the
        reference's rule) and the taken branch's result returned (the
        true branch's when the predicate is fake)."""
        pred, true_fn, false_fn, operands = args
        runs = []
        for fn in (true_fn, false_fn):
            saved = (self.total, self.transcendentals, self._loops,
                     self._layer)
            self.total, self._loops = Cost(), []
            with self:
                out = fn(*operands)
            runs.append((out, self.total, self.transcendentals))
            self.total, self.transcendentals, self._loops, self._layer = \
                saved
        fake = isinstance(pred, torch._subclasses.fake_tensor.FakeTensor)
        take = 0 if fake or bool(pred) else 1
        dear = max(runs, key=lambda r: r[1].flops + r[1].hbm_bytes)
        self._add(torch.ops.higher_order.cond, dear[1])
        return runs[take][0]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.higher_order.cond:
            return self._cond(args, kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            self.warnings.append(f"{func}: not priced")
            return func(*args, **kwargs)
        packet = func.overloadpacket
        if packet not in flop_registry and func.namespace == "aten" \
                and _decomposes(func):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        # a pre-existing tensor first seen here lived since the step began
        for t in ins:
            self._see(t, since="host")
        out = func(*args, **kwargs)
        outs = _tensors(out)
        c = Cost()
        if packet in flop_registry:
            c.flops = float(flop_registry[packet](*args, **kwargs,
                                                  out_val=out))
        if func.namespace == "c10d":
            op = collective_op(func, args)
            if op is not None:
                self.collectives.append(op)
                c.wire_bytes = op.wire_bytes
                c.coll = {op.opcode: op.wire_bytes}
                c.hbm_bytes = float(op.operand_bytes + op.output_bytes)
        else:
            c.hbm_bytes = self._bytes(func, ins, outs)
        if packet in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            self._see(t)
        self._add(packet, c)
        return out


def analyze(rec: OpCostRecorder, *, loops: bool = False) -> dict:
    """The reference's ``analyze`` keys of a finished recording: per-rank
    ``flops``, ``hbm_bytes``, ``wire_bytes``, ``collectives`` (wire bytes
    by type), ``warnings`` and, with ``loops``, one entry a marked loop
    and a layer segment, dearest first."""
    c = rec.total
    out = {
        "flops": c.flops,
        "hbm_bytes": c.hbm_bytes,
        "wire_bytes": c.wire_bytes,
        "collectives": dict(c.coll),
        "warnings": rec.warnings[:20],
    }
    if loops:
        out["loops"] = rec.loops()
    return out


def top_instructions(rec: OpCostRecorder, *, by: str = "bytes",
                     n: int = 10) -> List[dict]:
    """The ops dearest by ``by`` ("bytes" or "flops"), each summed over
    its calls: {op, count, flops, bytes, wire_bytes}."""
    key = "bytes" if by == "bytes" else "flops"
    return sorted(rec.by_op.values(), key=lambda r: -r[key])[:n]
