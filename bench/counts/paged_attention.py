"""Operations and bytes a paged-attention call (kernel B1) needs, from its
arguments: each input byte counted once (a page that several rows alias
is read once), each output byte written once, and for each real query
the keys it may read (causal, up to the row's valid length)."""
from __future__ import annotations

import numpy as np


def call_cost(*, B: int, S: int, H: int, hd: int, q_itemsize: int,
              kv_heads: int, page_size: int, bits: int,
              page_table: np.ndarray, q_start: np.ndarray,
              kv_len: np.ndarray) -> tuple:
    """(FLOPs, bytes) of one call. ``page_table`` (B, NP) int;
    ``q_start``, ``kv_len`` (B,) int; ``bits`` 8 or 4 (integer pages) or
    0 (bf16 pages); the output is float32."""
    q_start = np.broadcast_to(np.asarray(q_start, np.int64), (B,))
    kv_len = np.broadcast_to(np.asarray(kv_len, np.int64), (B,))
    real = np.clip(kv_len - q_start, 0, S)              # real queries a row
    keys = 0
    for b in range(B):
        n = int(real[b])
        first = int(q_start[b]) + 1                     # keys of query 0
        keys += n * first + n * (n - 1) // 2
    flops = 4.0 * H * hd * keys
    npages = -(-kv_len // page_size)
    used = [page_table[b, :int(npages[b])] for b in range(B)]
    distinct = len(np.unique(np.concatenate(used))) if used else 0
    elem = bits / 8 if bits else 2
    page_bytes = 2 * page_size * kv_heads * hd * elem + 2 * 4
    bytes_ = (distinct * page_bytes
              + B * S * H * hd * q_itemsize             # q
              + B * S * H * hd * 4                      # out
              + int(npages.sum()) * 4 + 2 * B * 4)      # page table, lens
    return flops, float(bytes_)
