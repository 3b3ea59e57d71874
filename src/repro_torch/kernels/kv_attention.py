"""Dense int8 KV-cache decode attention — a thin wrapper over the paged
kernel, as in the reference.

A contiguous (B, T, KV, hd) cache is the special case of a paged pool whose
page table is the identity (row b's page p is pool page b * NP + p) and
whose per-page scales are all the layer's Q(I,F) scale 2^-F. ``block_t``
becomes the page size. No kernel of its own: it runs
``paged_kv_attention_decode`` (the CUDA kernel on the card, its plain
version on the CPU).
"""
from __future__ import annotations

import math

import torch

from .paged_kv_attention import paged_kv_attention_decode


def kv_attention_decode(q, k_q, v_q, kv_len, *, int_bits: int,
                        frac_bits: int, block_t: int = 512) -> torch.Tensor:
    """q: (B, H, hd) float; k_q/v_q: (B, T, KV, hd) int8 Q(I,F) grid;
    kv_len: scalar int. Returns (B, H, hd) float32. ``int_bits`` is unused:
    the range is already encoded in the stored grid."""
    del int_bits
    B, H, hd = q.shape
    T, KV = k_q.shape[1], k_q.shape[2]
    ps = min(block_t, T)
    pad = (-T) % ps
    if pad:
        k_q = torch.nn.functional.pad(k_q, (0, 0, 0, 0, 0, pad))
        v_q = torch.nn.functional.pad(v_q, (0, 0, 0, 0, 0, pad))
    NP = k_q.shape[1] // ps
    k_pages = k_q.contiguous().reshape(B * NP, ps, KV, hd)
    v_pages = v_q.contiguous().reshape(B * NP, ps, KV, hd)
    dev = q.device
    page_table = torch.arange(B * NP, dtype=torch.int32,
                              device=dev).reshape(B, NP)
    scale = torch.full((B * NP,), math.ldexp(1.0, -int(frac_bits)),
                       dtype=torch.float32, device=dev)
    lens = torch.full((B,), int(kv_len), dtype=torch.int32, device=dev)
    return paged_kv_attention_decode(q, k_pages, v_pages, scale, scale,
                                     page_table, lens, bits=8)
