"""Bit packing: k N-bit two's-complement values per int32 word.

Field i of a word sits at bits ``[i*bits, (i+1)*bits)`` (little-endian
within the word), exactly as ``repro.core.qtensor``; the CUDA kernels
(int4 attention pages, ``kernels/pack``) use the same convention.

``QuantizedTensor`` makes the paper's footprint reduction real: the
integer grid lives in the smallest byte-aligned container (int8/int16),
and formats of at most 16 bits can instead be lane-packed, k values per
int32 word. It is a plain dataclass; ``nbytes`` is the true stored size.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .fixedpoint import FixedPointFormat, dequantize, quantize


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


@dataclasses.dataclass
class QuantizedTensor:
    """Fixed-point tensor with an explicit storage container.

    ``data`` is either a small-int container (int8/int16/int32) holding
    the integer grid directly, or an int32 lane-packed buffer (the last
    axis padded to whole words) when ``packed`` is True."""

    data: torch.Tensor
    int_bits: int
    frac_bits: int
    shape: tuple  # logical shape
    packed: bool = False

    @property
    def fmt(self) -> FixedPointFormat:
        return FixedPointFormat(self.int_bits, self.frac_bits)

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits

    @property
    def nbytes(self) -> int:
        return self.data.numel() * self.data.element_size()

    @property
    def logical_nbytes_fp32(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n * 4

    @property
    def footprint_ratio(self) -> float:
        """stored bytes / fp32 bytes: the paper's TR numerator per tensor."""
        return self.nbytes / max(self.logical_nbytes_fp32, 1)

    @classmethod
    def from_float(cls, x: torch.Tensor, int_bits: int, frac_bits: int, *,
                   pack: bool = False, rounding="nearest",
                   generator: Optional[torch.Generator] = None
                   ) -> "QuantizedTensor":
        fmt = FixedPointFormat(int_bits, frac_bits)
        q = quantize(x, int_bits, frac_bits, rounding=rounding,
                     generator=generator)
        shape = tuple(x.shape)
        if pack:
            if fmt.total_bits > 16:
                raise ValueError("packing supports <=16-bit formats")
            words, _ = pack_bits(q.reshape(-1) if q.dim() == 0 else q,
                                 fmt.total_bits)
            return cls(words, int_bits, frac_bits, shape, packed=True)
        return cls(q.to(fmt.container_dtype()), int_bits, frac_bits, shape)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        if self.packed:
            vals = unpack_bits(self.data, self.total_bits, self.shape[-1])
            vals = vals.reshape(self.shape)
        else:
            vals = self.data
        return dequantize(vals, self.int_bits, self.frac_bits).to(dtype)
