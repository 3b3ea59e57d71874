"""Feed-forward layers: SwiGLU (LLaMA family) and the GELU MLP (encoder
family)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .common import dense_init, frozen


class SwiGLU(nn.Module):
    """Weights in the reference's ``(in, out)`` layout, allocated
    uninitialized; :func:`init_swiglu` or a weight loader fills them."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        mk = lambda *shape: frozen(torch.empty(shape, dtype=dtype,
                                               device=device))
        self.w_gate = mk(d_model, d_ff)
        self.w_up = mk(d_model, d_ff)
        self.w_down = mk(d_ff, d_model)

    def forward(self, x):
        return swiglu_apply(self, x)


def init_swiglu(p: SwiGLU, generator: torch.Generator) -> None:
    d_ff = p.w_down.shape[0]
    p.w_gate.copy_(dense_init(p.w_gate.shape, torch.float32, generator,
                              p.w_gate.device))
    p.w_up.copy_(dense_init(p.w_up.shape, torch.float32, generator,
                            p.w_up.device))
    p.w_down.copy_(dense_init(p.w_down.shape, torch.float32, generator,
                              p.w_down.device, scale=1.0 / np.sqrt(d_ff)))


def swiglu_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    """silu(x W_gate) * (x W_up), then W_down; silu in float32."""
    cd = x.dtype
    g = x @ p.w_gate
    u = x @ p.w_up
    h = torch.nn.functional.silu(g.to(torch.float32)).to(cd) * u
    return h @ p.w_down


class GeluMLP(nn.Module):
    """The encoder's FFN: ``w_in`` (d_model, d_ff) with bias ``b_in``, then
    ``w_out`` (d_ff, d_model) with bias ``b_out``, all in the compute dtype
    (the reference casts each to it at use); see :func:`init_gelu_mlp`."""

    def __init__(self, d_model: int, d_ff: int, dtype, device=None):
        super().__init__()
        mk = lambda *shape: frozen(torch.empty(shape, dtype=dtype,
                                               device=device))
        self.w_in = mk(d_model, d_ff)
        self.b_in = mk(d_ff)
        self.w_out = mk(d_ff, d_model)
        self.b_out = mk(d_model)

    def forward(self, x):
        return gelu_mlp_apply(self, x)


def init_gelu_mlp(p: GeluMLP, generator: torch.Generator) -> None:
    """The reference's init: fan-in truncated normal weights, ``w_out``
    at std 1/sqrt(d_ff), zero biases."""
    d_ff = p.w_out.shape[0]
    p.w_in.copy_(dense_init(p.w_in.shape, torch.float32, generator,
                            p.w_in.device))
    p.w_out.copy_(dense_init(p.w_out.shape, torch.float32, generator,
                             p.w_out.device, scale=1.0 / np.sqrt(d_ff)))
    p.b_in.zero_()
    p.b_out.zero_()


def gelu_mlp_apply(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    """gelu(x W_in + b_in) W_out + b_out. GELU is the tanh form
    (``jax.nn.gelu``'s default ``approximate=True``; torch's default is
    the erf form), computed in float32 and cast back to x's dtype."""
    cd = x.dtype
    h = x @ p.w_in + p.b_in
    h = torch.nn.functional.gelu(h.to(torch.float32),
                                 approximate="tanh").to(cd)
    return h @ p.w_out + p.b_out
