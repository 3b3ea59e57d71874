"""Plain reference of a served dense GQA decoder (Qwen2 / DeepSeek-LLM
layout): RMSNorm, QKV with optional bias, rotate-half RoPE, causal
softmax attention, SwiGLU, an untied head. Float32 throughout, TF32 off,
and the KV written to the configuration's fixed-point grid (the int8
pool's Q(I,F)), as the served model stores it.

It runs layer by layer over groups of sequences that share a prefix (a
document): the prefix's keys and values are computed once per layer and
each suffix attends to them and to its own, which is the full causal
forward of prefix + suffix, split only where attention is linear in its
keys. Weights come from ``weights.py``, drawn again from the seed;
``weight_map`` rounds them for a control run in a lower precision.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .weights import Dims, make_embed, make_head, make_layer

MLP_BLOCK = 4096      # tokens per MLP block (bounds the d_ff transients)
ATTN_BLOCK = 512      # queries per attention block


def no_tf32() -> None:
    """Float32 matmuls in float32 (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_columns(w: torch.Tensor) -> torch.Tensor:
    """``w`` (in, out) rounded through float8 e4m3 with one absmax scale
    per output column: the control's weights."""
    s = torch.clamp(w.abs().amax(dim=0, keepdim=True), min=1e-30) / 448.0
    return (w / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def kv_grid(x: torch.Tensor, fmt: Optional[Tuple[int, int]]):
    """``x`` on the Q(I,F) grid (round half to even, clamped), or as it
    is when ``fmt`` is None."""
    if fmt is None:
        return x
    i, f = fmt
    q = torch.clamp(torch.round(x * 2.0 ** f), -2.0 ** (i + f - 1),
                    2.0 ** (i + f - 1) - 1)
    return q / 2.0 ** f


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, n, hd) rotated by rotate-half RoPE at positions ``pos`` (S,);
    angles in float64."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=x.device) / half))
    ang = pos.to(torch.float64)[:, None] * inv[None, :]
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, q_pos, k_pos) -> torch.Tensor:
    """Causal GQA softmax attention: q (S, H, hd), k/v (T, KV, hd),
    positions (S,) and (T,); query head h reads KV head h // (H / KV)."""
    S, H, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    out = torch.empty_like(q)
    for s0 in range(0, S, ATTN_BLOCK):
        qb = q[s0:s0 + ATTN_BLOCK].reshape(-1, KV, G, hd)
        sc = torch.einsum("skgh,tkh->kgst", qb, k) / np.sqrt(hd)
        mask = k_pos[None, :] <= q_pos[s0:s0 + ATTN_BLOCK, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out[s0:s0 + ATTN_BLOCK] = torch.einsum(
            "kgst,tkh->skgh", p, v).reshape(-1, H, hd)
    return out


def _block(x, pos, w, dims: Dims, kv_fmt, prefix=None):
    """One layer over x (S, D) at positions ``pos``; ``prefix`` is the
    (keys, values, positions) this layer's queries also attend to.
    Returns (x, keys, values) with the keys and values on the KV grid."""
    S = x.shape[0]
    hd = dims.head_dim
    h = rmsnorm(x, w["norm1"], dims.norm_eps)
    q, k, v = h @ w["wq"], h @ w["wk"], h @ w["wv"]
    if dims.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rope(q.view(S, dims.heads, hd), pos, dims.rope_theta)
    k = kv_grid(rope(k.view(S, dims.kv_heads, hd), pos, dims.rope_theta),
                kv_fmt)
    v = kv_grid(v.view(S, dims.kv_heads, hd), kv_fmt)
    keys, vals, kpos = k, v, pos
    if prefix is not None:
        keys = torch.cat([prefix[0], k])
        vals = torch.cat([prefix[1], v])
        kpos = torch.cat([prefix[2], pos])
    o = attention(q, keys, vals, pos, kpos).reshape(S, -1)
    x = x + o @ w["wo"]
    for s0 in range(0, S, MLP_BLOCK):
        xb = x[s0:s0 + MLP_BLOCK]
        hb = rmsnorm(xb, w["norm2"], dims.norm_eps)
        g = torch.nn.functional.silu(hb @ w["w_gate"]) * (hb @ w["w_up"])
        x[s0:s0 + MLP_BLOCK] = xb + g @ w["w_down"]
    return x, k, v


Group = Tuple[Sequence[int], List[Tuple[Sequence[int], int]]]


@torch.no_grad()
def group_logits(dims: Dims, seed: int, groups: List[Group], *, device,
                 served_dtype, kv_fmt=None,
                 weight_map: Optional[Callable] = None
                 ) -> List[List[torch.Tensor]]:
    """Float32 logits of the reference. ``groups``: (prefix tokens,
    [(suffix tokens, read_from)]); every suffix continues its group's
    prefix, and its logits are read at suffix positions ``read_from`` and
    after. Returns, per group and suffix, (n_read, vocab) float32 logits.
    Weights are drawn in ``served_dtype`` (as the program holds them) and
    widened to float32; ``weight_map`` maps each matrix first."""
    no_tf32()
    wmap = weight_map or (lambda t: t)
    dev = torch.device(device)
    table = make_embed(dims, seed, served_dtype, dev)
    state = []
    for prefix, suffixes in groups:
        p = torch.as_tensor(np.asarray(prefix, np.int64), device=dev)
        xs = [table[p].to(torch.float32)] if len(p) else [None]
        poss = [torch.arange(len(p), device=dev)]
        for toks, _ in suffixes:
            t = torch.as_tensor(np.asarray(toks, np.int64), device=dev)
            xs.append(table[t].to(torch.float32))
            poss.append(len(p) + torch.arange(len(t), device=dev))
        state.append((xs, poss))
    del table
    for li in range(dims.layers):
        raw = make_layer(dims, seed, li, served_dtype, dev)
        w = {n: (wmap(t.to(torch.float32)) if t.dim() == 2
                 else t.to(torch.float32)) for n, t in raw.items()}
        del raw
        for xs, poss in state:
            pre = None
            if xs[0] is not None:
                xs[0], k, v = _block(xs[0], poss[0], w, dims, kv_fmt)
                pre = (k, v, poss[0])
            for j in range(1, len(xs)):
                xs[j], _, _ = _block(xs[j], poss[j], w, dims, kv_fmt, pre)
        del w
    head = wmap(make_head(dims, seed, served_dtype, dev).to(torch.float32))
    final = torch.ones(dims.d_model, device=dev)
    out = []
    for (prefix, suffixes), (xs, _) in zip(groups, state):
        out.append([rmsnorm(x[r:], final, dims.norm_eps) @ head
                    for x, (_, r) in zip(xs[1:], suffixes)])
    return out
