"""Shared model components: initializers, RMSNorm, RoPE, embedding and the
LM head.

Weights keep the reference's ``(in, out)`` layout, so ``x @ w`` is the same
product on both sides. LayerNorm, M-RoPE and the loss helpers are still to
port (ROADMAP queue A items 4, 11 and 12).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn


# ---------------------------------------------------------------------------
# Initializers (the reference's distributions; torch.Generator numbers)
# ---------------------------------------------------------------------------
def dense_init(shape, dtype, generator: torch.Generator, device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) truncated to [-2, 2], times
    ``scale`` (default 1/sqrt(fan_in)), drawn in float32 then cast."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std).to(dtype)


def embed_init(shape, dtype, generator: torch.Generator,
               device) -> torch.Tensor:
    """N(0, 0.02^2), drawn in float32 then cast."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return w.mul_(0.02).to(dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """An inference-only parameter."""
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5):
    """RMSNorm computed in float32, output in x's dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings. ``positions`` is (B, S) integer.
# ---------------------------------------------------------------------------
def rope_angles(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, computed in numpy float32 exactly as the
    reference does, then handed to torch. (half,)"""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _device_rope_angles(head_dim: int, theta: float,
                        device: torch.device) -> torch.Tensor:
    """:func:`rope_angles` copied to ``device`` once: a copy from host
    memory on every call would wait for the device's queued work."""
    return rope_angles(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S)."""
    dt = x.dtype
    half = x.shape[-1] // 2
    inv = _device_rope_angles(x.shape[-1], float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * inv     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embed_tokens(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup; ``table`` is already in the compute dtype."""
    return table[ids.to(torch.int64)]


def lm_head(kernel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(…, D) @ (D, V) -> logits in x's dtype."""
    return x @ kernel
