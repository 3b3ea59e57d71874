"""Gradient compression: the int8 fixed-point wire format with error
feedback (the reference's ``optim/compress.py``).

``compress_gradients`` quantizes each gradient (plus the carried residual)
to a symmetric absmax grid and keeps the quantization error as the next
step's residual; the compressed gradient holds values on the int grid in
the gradient's dtype, so a later all-reduce of them is faithful to an int8
wire. The reference puts one scale on each leaf of its tree, where a layer
leaf is stacked over its segment's periods; ``groups`` gives the
parameters that make up one such leaf one scale
(``launch.steps.reference_groups``). Under a mesh each gradient is this
rank's shard, and ``shards`` (``parallel.hints.ShardReductions``) maxes
each leaf's absmax over the ranks that shard it, so the grid is the
whole leaf's.

``quantized_allreduce`` is the reference's ring all-reduce with integer
hops over one axis of the active plan's mesh: a reduce-scatter of n - 1
hops, then an all-gather of n - 1 hops, each hop's payload requantized
with its own per-tensor absmax and sent as an int8 (or int16) tensor
with a float32 scale (``batch_isend_irecv``), accumulated in float32 in
the reference's order and with its compiled arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8
    error_feedback: bool = True


def _q_encode(x: torch.Tensor, bits: int,
              absmax: Optional[torch.Tensor] = None, *,
              scale: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax fixed point: (int8 or int16 q, float32 scale),
    the scale from ``absmax`` (default: ``x``'s own) unless given. The
    scale and ``x / scale`` divide by a tensor (a scalar divisor is a
    reciprocal multiply on CUDA); ``torch.round`` is half to even, as
    ``jnp.round``."""
    qmax = 2.0 ** (bits - 1) - 1.0
    if scale is None:
        if absmax is None:
            absmax = torch.amax(torch.abs(x))
        scale = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax,
                                                                 qmax)
    dtype = torch.int8 if bits <= 8 else torch.int16
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(dtype)
    return q, scale


def _q_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _ring_encode(x: torch.Tensor, bits: int):
    """``_q_encode`` as XLA compiles the reference's inside ``shard_map``:
    the division of the absmax by the constant qmax becomes a multiply by
    its float32 reciprocal (``x / scale`` stays a division)."""
    qmax = 2.0 ** (bits - 1) - 1.0
    absmax = torch.amax(torch.abs(x))
    scale = torch.clamp(absmax, min=1e-12) * torch.full_like(absmax,
                                                             1.0 / qmax)
    return _q_encode(x, bits, scale=scale)


def _fused_add(acc: torch.Tensor, q: torch.Tensor, s: torch.Tensor):
    """``acc + q * s`` rounded once to float32, as XLA contracts the
    reference's accumulation into one fused multiply-add: the product of
    an int16 and a float32 is exact in float64, and the float64 sum is
    rounded to float32."""
    return (q.to(torch.float64) * s.to(torch.float64)
            + acc.to(torch.float64)).to(torch.float32)


def _ring_hop(q: torch.Tensor, s: torch.Tensor, group, send_to: int,
              recv_from: int):
    """Send (q, s) to group rank ``send_to`` and receive the same shapes
    from ``recv_from``: the reference's ``ppermute`` of one hop."""
    import torch.distributed as dist
    q_r, s_r = torch.empty_like(q), torch.empty_like(s)
    to = dist.get_global_rank(group, send_to)
    frm = dist.get_global_rank(group, recv_from)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, q, to, group),
        dist.P2POp(dist.isend, s, to, group),
        dist.P2POp(dist.irecv, q_r, frm, group),
        dist.P2POp(dist.irecv, s_r, frm, group)])
    for r in reqs:
        r.wait()
    return q_r, s_r


def quantized_allreduce(x: torch.Tensor, axis_name: str, *, bits: int = 8,
                        mean: bool = True) -> torch.Tensor:
    """Ring all-reduce with int-quantized hops over ``axis_name``, an axis
    of the active plan's mesh (``parallel.hints.activation_hints``);
    every rank of the axis calls it with a float32 tensor of one shape.
    Returns the (approximately) all-reduced tensor, its mean over the
    axis's n ranks with ``mean`` (``x`` itself when n = 1).

    The reference's ring: ``x`` flattened and padded to a multiple of n
    as n chunks; n - 1 reduce-scatter hops, at hop i rank r sending its
    chunk (r - i) mod n and adding the received payload to its chunk
    (r - i - 1) mod n; then rank r owns chunk (r + 1) mod n and n - 1
    all-gather hops circulate the owned chunks. Every payload is
    requantized (per-tensor absmax, round half to even) and travels as an
    int8 (bits <= 8) or int16 tensor beside its float32 scale. The
    arithmetic is the reference's as XLA compiles it (``_ring_encode``,
    ``_fused_add``, the mean a multiply by the reciprocal), so the result
    is the reference's bit for bit."""
    from ..parallel.hints import active_plan
    plan = active_plan()
    if plan is None or axis_name not in plan.shape:
        raise ValueError(f"quantized_allreduce over {axis_name!r} needs an "
                         f"active plan whose mesh has that axis "
                         f"(activation_hints)")
    n = plan.shape[axis_name]
    if n == 1:
        return x
    import torch.distributed as dist
    group = plan.mesh.get_group(axis_name)
    idx = dist.get_group_rank(group, dist.get_rank())
    nxt, prv = (idx + 1) % n, (idx - 1) % n
    orig_shape = x.shape
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % n
    acc = torch.nn.functional.pad(flat, (0, pad)).reshape(n, -1)

    # reduce-scatter: after n - 1 hops rank idx owns the full sum of chunk
    # (idx + 1) % n
    for i in range(n - 1):
        send_c, recv_c = (idx - i) % n, (idx - i - 1) % n
        q, s = _ring_encode(acc[send_c], bits)
        q_r, s_r = _ring_hop(q, s, group, nxt, prv)
        acc[recv_c] = _fused_add(acc[recv_c], q_r, s_r)
    own = (idx + 1) % n

    # all-gather: circulate each owned chunk on its grid
    q, s = _ring_encode(acc[own], bits)
    out = torch.zeros_like(acc)
    out[own] = _q_decode(q, s)
    for i in range(n - 1):
        q, s = _ring_hop(q, s, group, nxt, prv)
        out[(own - i - 1) % n] = _q_decode(q, s)

    res = out.reshape(-1)
    if pad:
        res = res[:-pad]
    res = res.reshape(orig_shape)
    # the mean as XLA lowers the reference's division by the constant n: a
    # multiply by its float32 reciprocal
    return res * torch.full_like(res, 1.0 / n) if mean else res


def error_feedback_init(grads_like: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A float32 zero residual per gradient (``name -> tensor``; a module's
    ``named_parameters`` will do)."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in dict(grads_like).items()}


def compress_gradients(grads: Dict[str, torch.Tensor],
                       residual: Dict[str, torch.Tensor],
                       cfg: CompressionConfig, *,
                       groups: Iterable[Sequence[str]] = (), shards=None):
    """Quantize (grad + residual) to an absmax grid; keep the quantization
    error as the new residual. Each name in ``groups`` shares one scale
    with the rest of its group, the absmax over all of their elements;
    every other gradient has its own; under ``shards`` each absmax is the
    whole leaf's, maxed over the ranks. Returns (compressed grads, each in
    its gradient's dtype with values on the grid, new float32 residual),
    both ``name -> tensor``."""
    groups = [list(g) for g in groups]
    grouped = {n for g in groups for n in g}
    groups += [[n] for n in grads if n not in grouped]
    comp, new_res = {}, {}
    for names in groups:
        gfs = {}
        for n in names:
            gf = grads[n].to(torch.float32)
            gfs[n] = gf + residual[n] if cfg.error_feedback else gf
        absmax = (None if len(names) == 1 else torch.amax(torch.stack(
            [torch.amax(torch.abs(x)) for x in gfs.values()])))
        if shards is not None:
            if absmax is None:
                absmax = torch.amax(torch.abs(gfs[names[0]]))
            absmax = shards.leaf_max(names, absmax)
        for n, gf in gfs.items():
            g = grads[n]
            q, s = _q_encode(gf, cfg.bits, absmax)
            deq = _q_decode(q, s)
            del q
            comp[n] = deq.to(g.dtype)
            # gf is a fresh tensor unless it is the caller's float32
            # gradient
            new_res[n] = gf.sub_(deq) if gf is not g else gf - deq
        del gfs
    return ({n: comp[n] for n in grads}, {n: new_res[n] for n in grads})
