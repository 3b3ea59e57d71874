"""Fake quantization Q(I,F) — the paper's memory-boundary op — as one
elementwise pass.

Replaces the TPU kernel ``repro/kernels/quant_cast.py::_quant_cast_kernel``
with the hand-written CUDA kernel in ``csrc/quant_cast.cu`` (see its header
for the design). It is bound by bytes on the card: each element is read
and written once.

:func:`quant_cast` takes any rank (the kernel works on the flat buffer).
For CUDA tensors it launches the kernel (and counts the launch in
``quant_cast.launches``); for CPU tensors it runs :func:`quant_cast_plain`,
which is ``core.fixedpoint.fake_quant``. The kernel equals it bit for bit,
for float32 and bfloat16.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..core.fixedpoint import fake_quant, format_params
from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quant_cast_plain(x: torch.Tensor, int_bits: int,
                     frac_bits: int) -> torch.Tensor:
    """Plain PyTorch version: ``core.fixedpoint.fake_quant`` (nearest)."""
    return fake_quant(x, int_bits, frac_bits)


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("quant_cast")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.quant_cast_launch.argtypes = [vp, vp, ctypes.c_longlong, i,
                                          f, f, f, f, i, vp]
        lib.quant_cast_launch.restype = i
        _lib = lib
    return _lib


def quant_cast(x: torch.Tensor, int_bits: int,
               frac_bits: int) -> torch.Tensor:
    """Fake-quant Q(I,F) of ``x`` (any rank, float32 or bfloat16 on the
    card); returns a tensor of x's shape and dtype on the grid."""
    scale, qmin, qmax = format_params(int_bits, frac_bits)
    build.refuse_fake(x)
    if x.device.type == "cpu":
        return quant_cast_plain(x, int_bits, frac_bits)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quant_cast_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), _DTYPES[x.dtype],
            scale, math.ldexp(1.0, -int(frac_bits)), qmin, qmax,
            build.num_sms(x.device.index), stream)
    build.check_launch(lib, "quant_cast", err)
    quant_cast.launches += 1
    return out


quant_cast.launches = 0
