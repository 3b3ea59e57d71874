"""Public wrappers of the kernels, with the reference's names, signatures
and reshapes (``repro.kernels.ops``).

Each op dispatches on its input's device: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor runs the kernel's plain
PyTorch version. The reference's ``interpret`` argument has no meaning
here and is gone. Each op has an oracle in ``kernels.ref``.
"""
from __future__ import annotations

from . import ref
from .kv_attention import kv_attention_decode as kv_attention
from .pack import pack_2d, unpack_2d, values_per_word
from .paged_kv_attention import paged_kv_attention_chunk
from .paged_kv_attention import paged_kv_attention_decode as \
    paged_kv_attention
from .quant_cast import quant_cast
from .quant_matmul import quant_matmul as qmatmul


def pack(q, bits: int):
    """(..., N) int32 grid values -> (..., N / (32/bits)) int32 words."""
    shape = q.shape
    w = pack_2d(q.reshape(-1, shape[-1]), bits=bits)
    return w.reshape(*shape[:-1], shape[-1] // values_per_word(bits))


def unpack(w, bits: int):
    """(..., W) int32 words -> (..., W * 32/bits) int32 values."""
    shape = w.shape
    q = unpack_2d(w.reshape(-1, shape[-1]), bits=bits)
    return q.reshape(*shape[:-1], shape[-1] * values_per_word(bits))


__all__ = ["quant_cast", "pack", "unpack", "qmatmul", "kv_attention",
           "paged_kv_attention", "paged_kv_attention_chunk", "ref"]
