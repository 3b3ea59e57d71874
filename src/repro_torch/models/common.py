"""Shared model components: initializers, RMSNorm and LayerNorm, RoPE and
M-RoPE, embedding, the LM head and the training losses (token cross-entropy
and its sequence-chunked, rematerialized form).

Weights keep the reference's ``(in, out)`` layout, so ``x @ w`` is the same
product on both sides.
"""
from __future__ import annotations

import contextvars
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch._guards import detect_fake_mode
from torch.utils.checkpoint import checkpoint


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


def dense_init_(dst: torch.Tensor, generator: torch.Generator,
                scale: Optional[float] = None) -> None:
    """:func:`dense_init` of ``dst``'s shape written into ``dst``. A tensor
    of rank >= 3 (an expert stack) is drawn one leading slice at a time
    with the whole tensor's std (fan-in = ``shape[0]``, as the reference
    takes it), so the float32 staging is one slice, not the tensor."""
    if dst.dim() < 3:
        dst.copy_(dense_init(dst.shape, torch.float32, generator,
                             dst.device, scale))
        return
    std = scale if scale is not None else 1.0 / np.sqrt(dst.shape[0])
    for part in dst:
        part.copy_(dense_init(part.shape, torch.float32, generator,
                              dst.device, std))


def embed_init(shape, dtype, generator: torch.Generator,
               device) -> torch.Tensor:
    """N(0, 0.02^2), drawn in float32 then cast."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator)
    return w.mul_(0.02).to(dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """An inference-only parameter (a trainable model turns its gradients
    on: ``models.transformer.Transformer``)."""
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


def init_layernorm(d: int, dtype, device=None) -> dict:
    """LayerNorm parameters: unit ``scale``, zero ``bias``. No forward of
    the served families calls it (the encoder's blocks use RMSNorm, as the
    reference's do); kept with the reference's."""
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-5):
    """LayerNorm computed in float32 (biased variance), output in x's
    dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)
            + params["bias"].to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings. ``positions`` is (B, S) integer; M-RoPE takes
# (B, S, 3) temporal / height / width ids (Qwen2-VL) and rotates three bands
# of the half-dim frequency axis by one id stream each.
# ---------------------------------------------------------------------------
def rope_angles(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, computed in numpy float32 exactly as the
    reference does, then handed to torch. (half,)"""
    half = head_dim // 2
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def _device_cached(fn):
    """``fn`` (a tensor made on its ``device`` argument) cached per
    arguments, but made afresh under a fake-tensor mode (the dry run's,
    ``launch.dryrun``): a fake tensor kept in the cache would reach a
    later real run."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def get(*args):
        return fn(*args) if detect_fake_mode() is not None else cached(*args)

    return get


@_device_cached
def _device_rope_angles(head_dim: int, theta: float,
                        device: torch.device) -> torch.Tensor:
    """:func:`rope_angles` copied to ``device`` once: a copy from host
    memory on every call would wait for the device's queued work."""
    return rope_angles(head_dim, theta, device)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) with its two halves rotated by the float32 angles
    ``ang`` (B, S, D/2), in float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S)."""
    inv = _device_rope_angles(x.shape[-1], float(theta), x.device)
    return _rotate(x, positions[..., None].to(torch.float32) * inv)


MROPE_SECTIONS = (0.25, 0.375, 0.375)   # temporal / height / width bands


@_device_cached
def _mrope_bands(half: int, device: torch.device) -> torch.Tensor:
    """(half,) id stream of each frequency: 0 below ``b0``, 1 up to
    ``b1``, 2 above, with the reference's truncating band bounds
    (head_dim 128: 16 and 40; 80: 10 and 25; 16: 2 and 5)."""
    b0 = int(half * MROPE_SECTIONS[0])
    b1 = b0 + int(half * MROPE_SECTIONS[1])
    sel = torch.zeros(half, dtype=torch.int64)
    sel[b0:b1] = 1
    sel[b1:] = 2
    return sel.to(device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, S, H, D); positions3: (B, S, 3).
    The angles use :func:`apply_rope`'s float32 inverse frequencies; with
    the three ids equal it is :func:`apply_rope` at that id."""
    inv = _device_rope_angles(x.shape[-1], float(theta), x.device)
    bands = _mrope_bands(x.shape[-1] // 2, x.device)
    return _rotate(x, positions3.to(torch.float32)[..., bands] * inv)


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def embed_tokens(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Row lookup; ``table`` is already in the compute dtype."""
    return table[ids.to(torch.int64)]


def lm_head(kernel: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(…, D) @ (D, V) -> logits in x's dtype."""
    return x @ kernel


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def _token_nll(logits: torch.Tensor, labels: torch.Tensor):
    """(nll, valid) per token in float32: labels < 0 are not valid (any
    negative label, not only -100)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    idx = torch.clamp(labels.to(torch.int64), min=0)[..., None]
    ll = torch.gather(lf, -1, idx)[..., 0]
    return lse - ll, labels >= 0


def cross_entropy(logits, labels, mask=None) -> torch.Tensor:
    """Mean token cross-entropy in float32 over the valid tokens (labels
    >= 0, and ``mask`` > 0 where given), divided by max(n, 1)."""
    nll, valid = _token_nll(logits, labels)
    if mask is not None:
        valid = valid & (mask > 0)
    valid = valid.to(torch.float32)
    return torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1.0)


def chunked_ce_loss(hidden, head_w, labels, *, chunk: int, mask=None):
    """The head matmul fused with :func:`cross_entropy`, one sequence chunk
    at a time, each chunk's logits rematerialized in the backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
    body): the (B, S, V) float32 logits never exist at once. hidden
    (B, S, D); head_w (D, V); labels (B, S). The sequence is padded to a
    chunk multiple with label -100."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        pad = chunk - S % chunk
        hidden = nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = nn.functional.pad(labels, (0, pad), value=-100)
        if mask is not None:
            mask = nn.functional.pad(mask, (0, pad))
        S += pad

    def body(h, lab, msk):
        nll, valid = _token_nll(h @ head_w.to(h.dtype), lab)
        if msk is not None:
            valid = valid & (msk > 0)
        v = valid.to(torch.float32)
        return torch.sum(nll * v), torch.sum(v)

    nll_sum = n_valid = torch.zeros((), dtype=torch.float32,
                                    device=hidden.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        a, n = checkpoint(body, hidden[:, sl], labels[:, sl],
                          None if mask is None else mask[:, sl],
                          use_reentrant=False)
        nll_sum = nll_sum + a
        n_valid = n_valid + n
    return nll_sum / torch.clamp(n_valid, min=1.0)


# ---------------------------------------------------------------------------
# Layer scopes of the op-cost recorder (``launch.hlo_cost``)
# ---------------------------------------------------------------------------
LAYER_LISTENER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_layer_listener", default=None)


def enter_layer(x: torch.Tensor, li: Optional[int]) -> torch.Tensor:
    """Announce that layer ``li`` (None: past the last layer) reads the
    residual stream ``x`` next, to the op-cost recorder listening
    (``launch.hlo_cost.OpCostRecorder``, which attributes the ops of each
    layer, its backward included, to the layer's segment). Returns ``x``
    unchanged."""
    listen = LAYER_LISTENER.get()
    return x if listen is None else listen(x, li)
