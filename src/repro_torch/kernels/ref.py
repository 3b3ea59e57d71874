"""Oracles for every kernel, and the shared fragmented-pool fixture.

The oracles are built from the core library where it matters (the
fake-quant grid is ``core.fixedpoint.fake_quant``, the lane packing is
``core.qtensor.pack_bits``), so kernel == library == paper. The attention
oracles gather a row's pages into the logical dense view, dequantize with
the per-page scales and run masked softmax attention — no online softmax,
no page loop — so they check the kernels and their plain versions from a
different direction.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.fixedpoint import fake_quant, format_params
from ..core.paged_kv import paged_gather, per_row
from ..core.qtensor import pack_bits, unpack_bits
from .pack import values_per_word

NEG_INF = -1e30
_CONTAINER = {0: "fp", 8: "int8", 4: "int4"}


def quant_cast_ref(x, int_bits: int, frac_bits: int) -> torch.Tensor:
    """Fake-quant Q(I,F): round half away, clip, rescale (paper §2.1)."""
    return fake_quant(x, int_bits, frac_bits)


def pack_ref(q: torch.Tensor, bits: int) -> torch.Tensor:
    """q: (..., N) integer-grid values in [-2^(bits-1), 2^(bits-1)-1],
    N % (32/bits) == 0 (no padding, unlike ``pack_bits``). Returns
    (..., N // vpw) int32 words."""
    vpw = values_per_word(bits)
    if q.shape[-1] % vpw:
        raise ValueError(f"last dim {q.shape[-1]} is not a multiple of "
                         f"{vpw} values per word")
    return pack_bits(q, bits)[0]


def unpack_ref(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_ref` (sign-extending): (..., W) int32 ->
    (..., W * vpw) int32."""
    return unpack_bits(w, bits, w.shape[-1] * values_per_word(bits))


def quant_matmul_ref(a, wq, scales) -> torch.Tensor:
    """a: (M, K) float; wq: (K, N) int8/int16 grid; scales: (N,) float32.
    Returns (M, N) float32 = a @ (wq * scales)."""
    wf = wq.to(torch.float32) * scales.to(torch.float32)[None, :]
    return a.to(torch.float32) @ wf


def masked_decode_attention_ref(q, k, v, kv_len):
    """q: (B, H, hd); k/v: (B, T, KV, hd) float; kv_len: scalar or (B,).
    Returns (B, H, hd) float32."""
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).to(torch.float32) / np.sqrt(hd)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k.to(torch.float32))
    lens = per_row(kv_len, B, q.device)
    mask = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkh->bkgh", p, v.to(torch.float32))
    return o.reshape(B, H, hd)


def paged_kv_attention_ref(q, k_pages, v_pages, k_scale, v_scale,
                           page_table, kv_len, *, bits: int = 8):
    """Decode oracle: q (B, H, hd); other shapes as in the kernel."""
    pool = {"k_pages": k_pages, "v_pages": v_pages,
            "k_scale": k_scale, "v_scale": v_scale}
    k, v = paged_gather(pool, page_table, container=_CONTAINER[bits],
                        head_dim=q.shape[-1])
    return masked_decode_attention_ref(q, k, v, kv_len)


def paged_kv_attention_chunk_ref(q, k_pages, v_pages, k_scale, v_scale,
                                 page_table, q_start, kv_len, *,
                                 bits: int = 8):
    """Chunk oracle: per-row causal masking against absolute query
    positions ``q_start[b] + i`` and the row's ``kv_len``. q: (B, S, H, hd).
    Returns (B, S, H, hd) float32."""
    pool = {"k_pages": k_pages, "v_pages": v_pages,
            "k_scale": k_scale, "v_scale": v_scale}
    B, S, H, hd = q.shape
    k, v = paged_gather(pool, page_table, container=_CONTAINER[bits],
                        head_dim=hd)
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qs = per_row(q_start, B, q.device)
    lens = per_row(kv_len, B, q.device)
    qg = q.reshape(B, S, KV, G, hd).to(torch.float32) / np.sqrt(hd)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k.to(torch.float32))
    pos = torch.arange(T, device=q.device)
    q_pos = qs[:, None] + torch.arange(S, device=q.device)[None, :]
    mask = ((pos[None, None, :] <= q_pos[:, :, None])
            & (pos[None, None, :] < lens[:, None, None]))
    s = torch.where(mask[:, None, None, :, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkh->bskgh", p, v.to(torch.float32))
    return o.reshape(B, S, H, hd)


def make_fragmented_pool(rng: np.random.Generator, B, NP, ps, kv, hd, bits,
                         extra_pages=3):
    """A random quantized pool plus an OUT-OF-ORDER page table (non-scratch
    page ids shuffled across rows), as numpy arrays; draws from ``rng`` in
    the reference fixture's order, so one seed gives both packages the same
    pool. Returns ``(k_pages, v_pages, k_scale, v_scale, page_table)``.
    ``bits``: 8 (int8 grid), 4 (int32 words of packed 4-bit fields), 0
    (float32)."""
    P = 1 + B * NP + extra_pages
    shape = (P, ps, kv, hd)
    if bits == 8:
        kq = rng.integers(-128, 128, shape).astype(np.int8)
        vq = rng.integers(-128, 128, shape).astype(np.int8)
    elif bits == 4:
        kq = pack_bits(torch.from_numpy(
            rng.integers(-8, 8, shape).astype(np.int32)), 4)[0].numpy()
        vq = pack_bits(torch.from_numpy(
            rng.integers(-8, 8, shape).astype(np.int32)), 4)[0].numpy()
    else:
        kq = rng.normal(size=shape).astype(np.float32)
        vq = rng.normal(size=shape).astype(np.float32)
    ks = rng.uniform(0.005, 0.08, P).astype(np.float32)
    vs = rng.uniform(0.005, 0.08, P).astype(np.float32)
    ids = np.arange(1, P)
    rng.shuffle(ids)
    pt = ids[:B * NP].reshape(B, NP).astype(np.int32)
    return kq, vq, ks, vs, pt


def kv_attention_ref(q, k_q, v_q, int_bits: int, frac_bits: int, kv_len):
    """q: (B, H, hd) float; k_q/v_q: (B, T, KV, hd) int8 grid; kv_len:
    int. GQA decode: one new token attends to the first kv_len cache
    entries. Returns (B, H, hd) float32."""
    scale, _, _ = format_params(int_bits, frac_bits)
    k = k_q.to(torch.float32) / scale
    v = v_q.to(torch.float32) / scale
    return masked_decode_attention_ref(q, k, v, kv_len)
