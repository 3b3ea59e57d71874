"""Parameterized fixed-point Q(I,F) representation (paper §2.1).

An N-bit fixed-point format splits into I integer bits (including the sign)
and F fractional bits: integer grid q in [-(2^(I+F-1)), 2^(I+F-1) - 1],
value = q * 2^-F. Values are quantized when they cross a memory boundary
and converted back to float before compute ("fake quant"). This module is
the numerical core of the port, plain torch on float32: the CUDA kernel
``kernels/quant_cast`` must equal :func:`fake_quant` bit for bit.

Format parameters are python ints (the reference also takes traced
arrays for ``lax.scan``; the port runs its layers in a Python loop).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

import torch

RoundingMode = Literal["nearest", "stochastic", "floor"]

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

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def qmin(self) -> int:
        return -(2 ** (self.total_bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.total_bits - 1) - 1

    @property
    def max_value(self) -> float:
        return self.qmax / self.scale

    @property
    def min_value(self) -> float:
        return self.qmin / self.scale

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale

    def container_dtype(self) -> torch.dtype:
        """Smallest signed-int container that holds the integer grid."""
        if self.total_bits <= 8:
            return torch.int8
        if self.total_bits <= 16:
            return torch.int16
        return torch.int32

    def short(self) -> str:
        return f"Q{self.int_bits}.{self.frac_bits}"

    @staticmethod
    def parse(s: str) -> "FixedPointFormat":
        s = s.strip().lstrip("Qq")
        i, f = s.split(".")
        return FixedPointFormat(int(i), int(f))


def format_params(int_bits: int, frac_bits: int):
    """(scale, qmin, qmax) as python floats for one Q(I,F) format.

    ``ldexp`` gives exact powers of two, as the reference requires (its
    ``exp2`` lowering was off by ~5e-4 at 2^13, breaking grid idempotency).
    """
    scale = math.ldexp(1.0, int(frac_bits))
    half = math.ldexp(1.0, int(int_bits) + int(frac_bits) - 1)
    return scale, -half, half - 1.0


def _round(x: torch.Tensor, mode: RoundingMode,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    if mode == "nearest":
        # round half away from zero, the usual hardware convert behaviour
        return torch.trunc(x + torch.copysign(torch.full_like(x, 0.5), x))
    if mode == "floor":
        return torch.floor(x)
    if mode == "stochastic":
        if generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        noise = torch.rand(x.shape, generator=generator, dtype=torch.float32,
                           device=x.device)
        return torch.floor(x + noise)
    raise ValueError(f"unknown rounding mode {mode!r}")


def quantize(x, int_bits: int, frac_bits: int, *,
             rounding: RoundingMode = "nearest",
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """float -> integer grid (float32-typed; cast to a container
    separately). ``generator`` draws the noise of stochastic rounding."""
    x = torch.as_tensor(x).to(torch.float32)
    scale, qmin, qmax = format_params(int_bits, frac_bits)
    q = _round(x * scale, rounding, generator)
    return torch.clamp(q, qmin, qmax)


def dequantize(q, int_bits: int, frac_bits: int) -> torch.Tensor:
    scale, _, _ = format_params(int_bits, frac_bits)
    return torch.as_tensor(q).to(torch.float32) / scale


def fake_quant(x, int_bits: int, frac_bits: int, *,
               rounding: RoundingMode = "nearest",
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Quantize-then-dequantize: the paper's memory-boundary conversion.

    The output dtype follows the input dtype (bf16 stays bf16) but the
    value set is the Q(I,F) grid."""
    x = torch.as_tensor(x)
    q = quantize(x, int_bits, frac_bits, rounding=rounding,
                 generator=generator)
    return dequantize(q, int_bits, frac_bits).to(x.dtype)


class _FakeQuantSTE(torch.autograd.Function):
    """Straight-through estimator: the forward is :func:`fake_quant`; the
    gradient passes unchanged where ``x * 2^F`` lies inside the grid's
    range and is 0 where the format clips."""

    @staticmethod
    def forward(ctx, x, int_bits, frac_bits):
        scale, qmin, qmax = format_params(int_bits, frac_bits)
        s = x.to(torch.float32) * scale
        ctx.save_for_backward((s >= qmin) & (s <= qmax))
        return fake_quant(x, int_bits, frac_bits)

    @staticmethod
    def backward(ctx, g):
        (in_range,) = ctx.saved_tensors
        return torch.where(in_range, g, torch.zeros_like(g)), None, None


def fake_quant_ste(x: torch.Tensor, int_bits: int,
                   frac_bits: int) -> torch.Tensor:
    """:func:`fake_quant` with a straight-through gradient (inside the
    representable range only), for quantization-aware training."""
    return _FakeQuantSTE.apply(x, int_bits, frac_bits)


def quantization_error(x, int_bits: int, frac_bits: int) -> torch.Tensor:
    """RMS error introduced by the format on a tensor (diagnostics)."""
    x = torch.as_tensor(x)
    d = x.to(torch.float32) - fake_quant(x, int_bits, frac_bits).to(
        torch.float32)
    return torch.sqrt(torch.mean(d * d))


def required_int_bits(max_abs) -> torch.Tensor:
    """Smallest I (incl. sign) whose range covers ``max_abs``
    (calibration): 2^(I-1) >= max_abs."""
    max_abs = torch.as_tensor(max_abs, dtype=torch.float32)
    i = torch.ceil(torch.log2(torch.clamp(max_abs, min=1e-30))) + 1.0
    return torch.clamp(i, min=1.0).to(torch.int32)
