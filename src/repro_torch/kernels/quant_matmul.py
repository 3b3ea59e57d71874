"""A (float32 | bf16) x W (int8 | int16 grid, per-channel scale) -> float32.

The paper's per-layer weight bits made computable without a dequantized
weight copy in device memory. Replaces the TPU kernel
``repro/kernels/quant_matmul.py::_qmm_kernel`` with the hand-written CUDA
kernels in ``csrc/quant_matmul.cu`` (see its header for the design). At
decode it is bound by the bytes of the int weight, at many rows by the
operations.

:func:`quant_matmul` keeps the reference's signature. For CUDA tensors it
launches a kernel (counted in ``quant_matmul.launches``, one a call; the
route and tile of the last call in ``quant_matmul.last_plan``, and for
the tensor-core route its splits, blocks per SM and shared memory); for CPU tensors it runs
:func:`quant_matmul_plain`. The route is explicit (:func:`kernel_route`):
the tensor-core kernel for an int8 grid with aligned rows, the float32-FMA
kernel for every other call. A failed build or launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import build
from .ref import quant_matmul_ref

_A_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_W_DTYPES = {torch.int8: 0, torch.int16: 1}
H100_SMS = 132
_TILE_CODES = {"decode": 0, "prefill": 1}
DECODE_MAX_ROWS = 32
# bf16 parts of an `a` value (kParts in csrc for float32; the library's
# config query reports it, and the card tests hold the two equal)
A_PARTS = {torch.bfloat16: 1, torch.float32: 2}
MIN_SPLIT_STEPS = 8         # no split shorter than this many K steps
MAX_SPLITS = 32


def quant_matmul_plain(a: torch.Tensor, wq: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``kernels.ref.quant_matmul_ref``, the float32
    product with the dequantized grid. Never the route on a card."""
    return quant_matmul_ref(a, wq, scales)


def quant_matmul_partial_plain(a: torch.Tensor, wq: torch.Tensor,
                               k_range: Tuple[int, int]) -> torch.Tensor:
    """Plain version of one split's partial: the float32 product of the
    columns ``k_range`` of ``a`` with those rows of the grid, unscaled."""
    k0, k1 = k_range
    return a[:, k0:k1].to(torch.float32) @ wq[k0:k1].to(torch.float32)


def merge_splits_plain(parts: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """Plain version of the merge kernel: the (n, M, N) partials summed in
    split order, then multiplied by the scales."""
    out = parts[0].clone()
    for p in parts[1:]:
        out += p
    return out * scales.to(torch.float32)[None, :]


def kernel_route(a: torch.Tensor, wq: torch.Tensor,
                 scales: torch.Tensor) -> str:
    """"mma" (the tensor-core kernel) for an int8 grid with N % 16 == 0,
    rows of ``a`` a whole number of 16-byte chunks (K % 8 == 0 for bf16,
    K % 4 == 0 for float32) and every buffer 16-byte aligned; "fma" (the
    float32-FMA kernel) for every other call, such as an int16 grid."""
    K, N = wq.shape
    if (wq.dtype == torch.int8 and a.dtype in _A_DTYPES and N % 16 == 0
            and K * a.element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (a, wq, scales))):
        return "mma"
    return "fma"


def qmm_tile(M: int) -> str:
    """The tensor-core kernel's tile for M rows: "decode" for M <= 32,
    else "prefill"."""
    return "decode" if M <= DECODE_MAX_ROWS else "prefill"


class QmmPlan(NamedTuple):
    tile: str               # "decode" or "prefill"
    splits: int
    steps_per_split: int    # K steps of k_step each
    k_step: int             # the tile's BK

    def k_ranges(self, K: int) -> Tuple[Tuple[int, int], ...]:
        """The contiguous run of K each split covers, in split order."""
        step = self.steps_per_split * self.k_step
        return tuple((k, min(k + step, K)) for k in range(0, K, step))


def split_k(tiles: int, ksteps: int, slots: int) -> Tuple[int, int]:
    """(splits, K steps a split) for a grid of ``tiles`` output tiles over
    ``ksteps`` K steps on a card with ``slots`` resident blocks. A grid
    that fills one wave alone is not split. Otherwise K's steps are cut
    into equal runs (the last may be shorter; none shorter than
    ``MIN_SPLIT_STEPS``, at most ``MAX_SPLITS``): among the counts whose
    grid fills a wave, the fewest splits whose time in steps (waves x
    steps a split) is within 10% of the best."""
    if tiles >= slots:
        return 1, ksteps
    options = {}
    for s in range(1, max(1, min(MAX_SPLITS, ksteps // MIN_SPLIT_STEPS)) + 1):
        per = -(-ksteps // s)
        n = -(-ksteps // per)
        options[n] = (-(-tiles * n // slots) * per, per)
    filling = [n for n in options if tiles * n >= slots] or [max(options)]
    best = min(options[n][0] for n in filling)
    n = min(n for n in filling if options[n][0] <= 1.1 * best)
    return n, options[n][1]


@functools.lru_cache(maxsize=256)
def plan_qmm(M: int, N: int, K: int, shape: Tuple[int, int, int], *,
             sms: int = H100_SMS, blocks_per_sm: int = 1) -> QmmPlan:
    """The tensor-core kernel's split-K plan, from the shapes and the
    card's occupancy alone (so runs repeat bitwise): ``shape`` is the
    (BM, BN, BK) of the tile :func:`qmm_tile` names for M, as the library
    reports it, and :func:`split_k` cuts K so that the grid fills the
    ``sms * blocks_per_sm`` resident blocks."""
    bm, bn, bk = shape
    tiles = -(-M // bm) * -(-N // bn)
    splits, per = split_k(tiles, -(-K // bk), sms * max(1, blocks_per_sm))
    return QmmPlan(qmm_tile(M), splits, per, bk)


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("quant_matmul")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.quant_matmul_launch.argtypes = [vp] * 4 + [i] * 5 + [vp]
        lib.quant_matmul_launch.restype = i
        lib.quant_matmul_mma_launch.argtypes = [vp] * 5 + [i] * 7 + [vp]
        lib.quant_matmul_mma_launch.restype = i
        lib.quant_matmul_mma_config.argtypes = [i, i,
                                                ctypes.POINTER(ctypes.c_int)]
        lib.quant_matmul_mma_config.restype = i
        _lib = lib
    return _lib


class MmaConfig(NamedTuple):
    blocks_per_sm: int
    smem_bytes: int
    shape: Tuple[int, int, int]     # the tile's (BM, BN, BK)
    a_parts: int                    # bf16 parts of an `a` value


@functools.lru_cache(maxsize=None)
def _mma_config(device: int, a_code: int, tile: str) -> MmaConfig:
    """The tensor-core kernel's instantiation for ``a``'s dtype code and
    ``tile``, as the library reports it. Raises if it cannot launch."""
    lib = _library()
    q = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        err = lib.quant_matmul_mma_config(a_code, _TILE_CODES[tile], q)
    build.check_launch(lib, "quant_matmul", err)
    if q[0] < 1:
        raise RuntimeError(f"quant_matmul: the {tile} tensor-core kernel "
                           f"cannot launch on device {device}")
    return MmaConfig(q[0], q[1], (q[2], q[3], q[4]), q[5])


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
    dev = a.device.index
    a_code, w_code = _A_DTYPES[a.dtype], _W_DTYPES[wq.dtype]
    route = kernel_route(a, wq, scales)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if route == "mma":
            cfg = _mma_config(dev, a_code, qmm_tile(M))
            plan = plan_qmm(M, N, K, cfg.shape, sms=build.num_sms(dev),
                            blocks_per_sm=cfg.blocks_per_sm)
            part = (torch.empty((plan.splits, M, N), dtype=torch.float32,
                                device=a.device) if plan.splits > 1 else None)
            err = lib.quant_matmul_mma_launch(
                a.data_ptr(), wq.data_ptr(), scales.data_ptr(),
                out.data_ptr(), None if part is None else part.data_ptr(),
                M, N, K, a_code, _TILE_CODES[plan.tile],
                plan.steps_per_split, plan.splits, stream)
            info = {"tile": plan.tile, "tile_shape": cfg.shape,
                    "splits": plan.splits,
                    "steps_per_split": plan.steps_per_split,
                    "blocks_per_sm": cfg.blocks_per_sm,
                    "smem_bytes": cfg.smem_bytes, "a_parts": cfg.a_parts}
        else:
            err = lib.quant_matmul_launch(
                a.data_ptr(), wq.data_ptr(), scales.data_ptr(),
                out.data_ptr(), M, N, K, a_code, w_code, stream)
            info = {"tile": "16x64" if M <= DECODE_MAX_ROWS else "128x128",
                    "splits": 1}
    build.check_launch(lib, "quant_matmul", err)
    quant_matmul.launches += 1
    quant_matmul.last_plan = {"route": route, **info}
    return out


quant_matmul.launches = 0
quant_matmul.last_plan = None
