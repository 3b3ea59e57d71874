"""Parameterized fixed-point Q(I,F) representation (paper §2.1).

An N-bit fixed-point format splits into I integer bits (including the sign)
and F fractional bits: integer grid q in [-(2^(I+F-1)), 2^(I+F-1) - 1],
value = q * 2^-F. This port carries the format and its (scale, qmin, qmax)
triple; the quantize/dequantize/fake-quant family of ``repro.core.fixedpoint``
is still to port (ROADMAP queue A item 1).
"""
from __future__ import annotations

import dataclasses
import math

MAX_TOTAL_BITS = 30  # int32-safe integer grid


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """A Q(I,F) fixed-point format. ``I`` includes the sign bit."""

    int_bits: int
    frac_bits: int

    def __post_init__(self):
        if self.int_bits < 1:
            raise ValueError(f"int_bits must be >= 1 (sign), got {self.int_bits}")
        if self.frac_bits < 0:
            raise ValueError(f"frac_bits must be >= 0, got {self.frac_bits}")
        if self.total_bits > MAX_TOTAL_BITS:
            raise ValueError(f"total bits {self.total_bits} > {MAX_TOTAL_BITS}")

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits


def format_params(int_bits: int, frac_bits: int):
    """(scale, qmin, qmax) as python floats for one Q(I,F) format.

    ``ldexp`` gives exact powers of two, as the reference requires (its
    ``exp2`` lowering was off by ~5e-4 at 2^13, breaking grid idempotency).
    """
    scale = math.ldexp(1.0, int(frac_bits))
    half = math.ldexp(1.0, int(int_bits) + int(frac_bits) - 1)
    return scale, -half, half - 1.0
