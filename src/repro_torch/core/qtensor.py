"""Bit packing: k N-bit two's-complement values per int32 word.

Field i of a word sits at bits ``[i*bits, (i+1)*bits)`` (little-endian
within the word), exactly as ``repro.core.qtensor``; the CUDA attention
kernel unpacks int4 pages with the same convention. ``QuantizedTensor`` is
still to port (ROADMAP queue A item 1).
"""
from __future__ import annotations

import torch


def values_per_word(bits: int) -> int:
    if not (1 <= bits <= 16):
        raise ValueError(f"pack supports 1..16 bit values, got {bits}")
    return 32 // bits


def pack_bits(q: torch.Tensor, bits: int):
    """Pack integer-grid values (any int/float dtype, already clipped to the
    N-bit two's-complement range) into int32 words along the last axis.

    The last axis is zero-padded to a multiple of ``values_per_word(bits)``.
    Returns (packed int32 tensor, original last-dim size).

    The fields are assembled in int64 (``torch.sum`` of int32 would promote
    anyway) and the words are wrapped back to int32 two's complement
    explicitly, so words with the top bit set come out negative as in the
    reference.
    """
    k = values_per_word(bits)
    n = q.shape[-1]
    pad = (-n) % k
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    qi = q.to(torch.int64) & ((1 << bits) - 1)          # two's complement field
    qi = qi.reshape(*qi.shape[:-1], -1, k)
    shifts = torch.arange(k, dtype=torch.int64, device=q.device) * bits
    words = torch.sum(qi << shifts, dim=-1)            # disjoint fields
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), n


def unpack_bits(packed: torch.Tensor, bits: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns int32 sign-extended values."""
    k = values_per_word(bits)
    packed = packed.to(torch.int32)
    shifts = torch.arange(k, dtype=torch.int32, device=packed.device) * bits
    fields = (packed[..., None] >> shifts) & ((1 << bits) - 1)
    sign = 1 << (bits - 1)
    vals = (fields ^ sign) - sign                       # sign extend
    vals = vals.reshape(*packed.shape[:-1], packed.shape[-1] * k)
    return vals[..., :n]
