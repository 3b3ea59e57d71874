"""N-bit <-> int32 lane packing: the paper's "N-bit memory" as k = 32/N
grid values per int32 word.

Replaces the TPU kernels ``repro/kernels/pack.py::_pack_kernel`` and
``_unpack_kernel`` with the hand-written CUDA kernels in ``csrc/pack.cu``
(see its header for the design). Both are bound by bytes on the card.

pack_2d  : (M, N)     int32 grid values -> (M, N/vpw) int32 words
unpack_2d: (M, N/vpw) int32 words       -> (M, N)     int32 values
(sign-extended), bits in {2, 4, 8, 16}, N % vpw == 0 (no padding, unlike
``core.qtensor.pack_bits``). For CUDA tensors each wrapper launches its
kernel (counted in ``pack_2d.launches`` / ``unpack_2d.launches``); for
CPU tensors it runs :func:`pack_plain` / :func:`unpack_plain`, which are
``core.qtensor.pack_bits`` / ``unpack_bits``.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.qtensor import pack_bits, unpack_bits
from . import build


def values_per_word(bits: int) -> int:
    if bits not in (2, 4, 8, 16):
        raise ValueError(f"the pack kernels take bits 2, 4, 8 or 16, got "
                         f"{bits}")
    return 32 // bits


def pack_plain(q: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., N) grid values -> (..., N/vpw) int32 words, by
    ``core.qtensor.pack_bits``."""
    values_per_word(bits)
    return pack_bits(q, bits)[0]


def unpack_plain(w: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., W*vpw) sign-extended int32 values, by
    ``core.qtensor.unpack_bits``."""
    return unpack_bits(w, bits, w.shape[-1] * values_per_word(bits))


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("pack")
        vp, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.pack_launch, lib.unpack_launch):
            fn.argtypes = [vp, vp, ctypes.c_longlong, i, i, vp]
            fn.restype = i
        _lib = lib
    return _lib


def _launch(fn_name: str, x: torch.Tensor, out: torch.Tensor, words: int,
            bits: int) -> None:
    for name, t in (("input", x), ("output", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"the {name} must be 16-byte aligned")
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, fn_name)(x.data_ptr(), out.data_ptr(), words,
                                    bits, build.num_sms(x.device.index),
                                    stream)
    build.check_launch(lib, "pack", err)


def _check_2d(x: torch.Tensor, what: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what} must be 2-D, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    if x.device.type == "cuda":
        if x.dtype != torch.int32:
            raise ValueError(f"{what} must be int32 on the card, got "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what} must be contiguous")


def pack_2d(q: torch.Tensor, *, bits: int) -> torch.Tensor:
    """q: (M, N) int32 grid values in [-2^(bits-1), 2^(bits-1)-1],
    N % (32/bits) == 0. Returns (M, N/vpw) int32 words."""
    vpw = values_per_word(bits)
    build.refuse_fake(q)
    _check_2d(q, "q")
    M, N = q.shape
    if N % vpw:
        raise ValueError(f"N = {N} is not a multiple of {vpw} values per "
                         f"word at bits={bits}")
    if q.device.type == "cpu":
        return pack_plain(q, bits)
    out = torch.empty((M, N // vpw), dtype=torch.int32, device=q.device)
    if out.numel():
        _launch("pack_launch", q, out, out.numel(), bits)
        pack_2d.launches += 1
    return out


def unpack_2d(w: torch.Tensor, *, bits: int) -> torch.Tensor:
    """w: (M, W) int32 packed words -> (M, W * 32/bits) int32 values."""
    vpw = values_per_word(bits)
    build.refuse_fake(w)
    _check_2d(w, "w")
    if w.device.type == "cpu":
        return unpack_plain(w, bits)
    M, W = w.shape
    out = torch.empty((M, W * vpw), dtype=torch.int32, device=w.device)
    if w.numel():
        _launch("unpack_launch", w, out, w.numel(), bits)
        unpack_2d.launches += 1
    return out


pack_2d.launches = 0
unpack_2d.launches = 0
