"""A (float32 | bf16) x W (int8 | int16 grid, per-channel scale) -> float32.

The paper's per-layer weight bits made computable without a dequantized
weight copy in device memory. Replaces the TPU kernel
``repro/kernels/quant_matmul.py::_qmm_kernel`` with the hand-written CUDA
kernel in ``csrc/quant_matmul.cu`` (see its header for the design). At
decode it is bound by the bytes of the int weight, at many rows by the
operations.

:func:`quant_matmul` keeps the reference's signature. For CUDA tensors it
launches the kernel (counted in ``quant_matmul.launches``); for CPU tensors
it runs :func:`quant_matmul_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import quant_matmul_ref

_A_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_W_DTYPES = {torch.int8: 0, torch.int16: 1}


def quant_matmul_plain(a: torch.Tensor, wq: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``kernels.ref.quant_matmul_ref``, the float32
    product with the dequantized grid. Never the route on a card."""
    return quant_matmul_ref(a, wq, scales)


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("quant_matmul")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul_launch.argtypes = [vp] * 4 + [i] * 5 + [vp]
        lib.quant_matmul_launch.restype = i
        _lib = lib
    return _lib


def quant_matmul(a: torch.Tensor, wq: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """a: (M, K) float; wq: (K, N) int8/int16 grid; scales: (N,) float32.
    Returns (M, N) float32 = a @ (wq * scales)."""
    if a.dim() != 2 or wq.dim() != 2 or a.shape[1] != wq.shape[0]:
        raise ValueError(f"a (M, K) and wq (K, N) do not match: "
                         f"{tuple(a.shape)} and {tuple(wq.shape)}")
    M, K = a.shape
    N = wq.shape[1]
    if scales.shape != (N,):
        raise ValueError(f"scales must be ({N},), got {tuple(scales.shape)}")
    if len({a.device, wq.device, scales.device}) != 1:
        raise ValueError("a, wq and scales lie on different devices")
    if a.device.type == "cpu":
        return quant_matmul_plain(a, wq, scales)
    if a.device.type != "cuda":
        raise ValueError(f"no kernel for device {a.device}")
    if a.dtype not in _A_DTYPES:
        raise ValueError(f"a must be float32 or bfloat16, got {a.dtype}")
    if wq.dtype not in _W_DTYPES:
        raise ValueError(f"wq must be int8 or int16, got {wq.dtype}")
    if scales.dtype != torch.float32:
        raise ValueError(f"scales must be float32, got {scales.dtype}")
    for name, t in (("a", a), ("wq", wq), ("scales", scales)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if out.numel() == 0 or K == 0:
        return out.zero_()
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.quant_matmul_launch(
            a.data_ptr(), wq.data_ptr(), scales.data_ptr(), out.data_ptr(),
            M, N, K, _A_DTYPES[a.dtype], _W_DTYPES[wq.dtype], stream)
    build.check_launch(lib, "quant_matmul", err)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
