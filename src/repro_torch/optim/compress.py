"""Gradient compression: the int8 fixed-point wire format with error
feedback (the reference's ``optim/compress.py``).

``compress_gradients`` quantizes each gradient (plus the carried residual)
to a symmetric absmax grid and keeps the quantization error as the next
step's residual; the compressed gradient holds values on the int grid in
the gradient's dtype, so a later all-reduce of them is faithful to an int8
wire. The reference puts one scale on each leaf of its tree, where a layer
leaf is stacked over its segment's periods; ``groups`` gives the
parameters that make up one such leaf one scale
(``launch.steps.reference_groups``). The ring all-reduce with int8 hops
(``quantized_allreduce``) needs a process group and belongs to the
distributed slice.
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
              absmax: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax fixed point: (int8 or int16 q, float32 scale),
    the scale from ``absmax`` (default: ``x``'s own). The scale and
    ``x / scale`` divide by a tensor (a scalar divisor is a reciprocal
    multiply on CUDA); ``torch.round`` is half to even, as
    ``jnp.round``."""
    qmax = 2.0 ** (bits - 1) - 1.0
    if absmax is None:
        absmax = torch.amax(torch.abs(x))
    scale = torch.clamp(absmax, min=1e-12) / torch.full_like(absmax, qmax)
    dtype = torch.int8 if bits <= 8 else torch.int16
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(dtype)
    return q, scale


def _q_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def quantized_allreduce(x, axis_name: str, *, bits: int = 8,
                        mean: bool = True):
    """The ring all-reduce with int-quantized hops: not ported yet."""
    raise NotImplementedError(
        "quantized_allreduce (the int8 ring all-reduce) is not ported yet: "
        "ROADMAP queue A item 13")


def error_feedback_init(grads_like: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """A float32 zero residual per gradient (``name -> tensor``; a module's
    ``named_parameters`` will do)."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in dict(grads_like).items()}


def compress_gradients(grads: Dict[str, torch.Tensor],
                       residual: Dict[str, torch.Tensor],
                       cfg: CompressionConfig, *,
                       groups: Iterable[Sequence[str]] = ()):
    """Quantize (grad + residual) to an absmax grid; keep the quantization
    error as the new residual. Each name in ``groups`` shares one scale
    with the rest of its group, the absmax over all of their elements;
    every other gradient has its own. Returns (compressed grads, each in
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
