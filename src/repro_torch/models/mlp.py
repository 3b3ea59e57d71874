"""Feed-forward layer: SwiGLU (LLaMA family). The GELU MLP of the encoder
family is still to port (ROADMAP queue A item 11)."""
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
