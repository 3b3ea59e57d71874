"""GQA variable-length attention over a paged, quantized KV pool — one
kernel for chunked prefill (S >= 1) and decode (S == 1).

Replaces the TPU kernel ``repro/kernels/paged_kv_attention.py::
_chunk_kernel`` with the hand-written CUDA kernel in
``csrc/paged_kv_attention.cu`` (see its header for the design). It is
bound by bytes on the card: every visible page of a row is read once per
KV head and query block, so the pages read per query block set its time.
The simple design stages pages in shared memory and multiplies on float32
FMAs; reuse of a page across query blocks and tensor cores are left for a
later change.

``block_kv=True`` selects the KV-head-blocked kernel, which replaces
``_chunk_kernel_kvblock``: one block per (query block, row) stages whole
pages, all KV heads, so each page is read once per query block. It
computes the same function, so its plain version is the default route's;
the two kernels agree to float rounding, not bitwise.

:func:`paged_kv_attention_chunk` keeps the reference's signature and
layouts. For CUDA tensors it launches the kernel (and counts the launch in
``paged_kv_attention_chunk.launches``); for CPU tensors it runs
:func:`paged_kv_attention_chunk_plain`, a page-by-page PyTorch version of
the same arithmetic. It never falls back from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.paged_kv import per_row
from ..core.qtensor import unpack_bits
from . import build

NEG_INF = -1e30

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.int32: 3}
_BITS_DTYPES = {8: (torch.int8,), 4: (torch.int32,),
                0: (torch.float32, torch.bfloat16)}
_SMEM_BUDGET = 100 * 1024   # bytes of shared memory per block we aim for
_SMEM_MAX = 232448          # the most one block can have on an H100
_MAX_TILE_KEYS = 64


def _dequant(x: torch.Tensor, scale: torch.Tensor, *, bits: int,
             head_dim: int) -> torch.Tensor:
    """(B, ps, KV, hdw) stored pages, (B,) scales -> (B, ps, KV, hd) f32."""
    if bits == 4:
        x = unpack_bits(x, 4, head_dim)
    return x.to(torch.float32) * scale[:, None, None, None]


def paged_kv_attention_chunk_plain(q, k_pages, v_pages, k_scale, v_scale,
                                   page_table, q_start, kv_len, *,
                                   bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same masked online softmax,
    one pool page per step, over every page-table column.

    (Columns past a row's last visible key add exp(-1e30 - m) = 0 and
    leave the state unchanged, so looping over all of them equals the
    kernel's early stop.) Returns (B, S, H, hd) float32."""
    B, S, H, hd = q.shape
    KV, ps = k_pages.shape[2], k_pages.shape[1]
    NP = page_table.shape[1]
    G = H // KV
    dev = q.device
    sm_scale = float(1.0 / np.sqrt(hd))
    qs = per_row(q_start, B, dev)
    lens = per_row(kv_len, B, dev)
    qf = q.to(torch.float32).reshape(B, S, KV, G, hd) * sm_scale
    q_pos = qs[:, None] + torch.arange(S, device=dev)[None, :]      # (B, S)
    m = torch.full((B, KV, S, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, S, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, S, G, hd), dtype=torch.float32, device=dev)
    pt = page_table.to(torch.int64)
    offs = torch.arange(ps, device=dev)
    for p in range(NP):
        ids = pt[:, p]
        k = _dequant(k_pages[ids], k_scale[ids], bits=bits, head_dim=hd)
        v = _dequant(v_pages[ids], v_scale[ids], bits=bits, head_dim=hd)
        s = torch.einsum("bskgh,btkh->bksgt", qf, k)           # (B,KV,S,G,ps)
        pos = p * ps + offs
        mask = ((pos[None, None, :] <= q_pos[:, :, None])
                & (pos[None, None, :] < lens[:, None, None]))   # (B, S, ps)
        s = torch.where(mask[:, None, :, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        pexp = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + pexp.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bksgt,btkh->bksgh",
                                                   pexp, v)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, S, H, hd)


def _check(q, k_pages, v_pages, k_scale, v_scale, page_table, bits):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, hd), got {tuple(q.shape)}")
    B, S, H, hd = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages/v_pages must both be (P, ps, KV, hdw), got "
                         f"{tuple(k_pages.shape)} and {tuple(v_pages.shape)}")
    P, ps, KV, hdw = k_pages.shape
    if bits not in _BITS_DTYPES:
        raise ValueError(f"bits must be 0, 4 or 8, got {bits}")
    if (k_pages.dtype not in _BITS_DTYPES[bits]
            or v_pages.dtype != k_pages.dtype):
        raise ValueError(f"bits={bits} pages must be "
                         f"{_BITS_DTYPES[bits]}, got {k_pages.dtype}")
    if hdw * (8 if bits == 4 else 1) != hd:
        raise ValueError(f"page width {hdw} does not hold head_dim {hd} at "
                         f"bits={bits}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if k_scale.shape != (P,) or v_scale.shape != (P,):
        raise ValueError(f"scales must be ({P},)")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be ({B}, NP), got "
                         f"{tuple(page_table.shape)}")
    devs = {t.device for t in (q, k_pages, v_pages, k_scale, v_scale,
                               page_table)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")


def _tiling(lib, *, block_kv: bool, block_q: int, S: int, G: int, KV: int,
            ps: int, hd: int):
    """(query rows per block, pages per tile) for one launch. The default
    kernel keeps ``block_q`` and takes the largest tile of up to 64 keys
    within its budget. The blocked kernel holds every KV head at once, so
    it takes the largest query block (halving ``block_q``), then tile,
    that fits one block's shared memory; raises if even one query and one
    page do not."""
    bq = max(1, min(block_q, S))
    if not block_kv:
        for tp in (4, 2):
            if (tp * ps <= _MAX_TILE_KEYS
                    and lib.paged_kv_attention_smem_bytes(bq * G, tp * ps, hd)
                    <= _SMEM_BUDGET):
                return bq, tp
        return bq, 1
    while True:
        for tp in (4, 2, 1):
            if (tp * ps <= _MAX_TILE_KEYS
                    and lib.paged_kv_attention_kvblock_smem_bytes(
                        bq * G, tp * ps, KV, hd) <= _SMEM_MAX):
                return bq, tp
        if bq == 1:
            raise ValueError(f"block_kv: one page of {KV} KV heads x {ps} "
                             f"keys x head_dim {hd} does not fit one "
                             f"block's shared memory")
        bq = max(1, bq // 2)


def _launch(q, k_pages, v_pages, k_scale, v_scale, page_table, qs, lens, *,
            bits: int, block_q: int, block_kv: bool) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises on a failed
    launch."""
    B, S, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    NP = page_table.shape[1]
    if q.dtype not in _Q_DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t, dt in (("k_scale", k_scale, torch.float32),
                        ("v_scale", v_scale, torch.float32),
                        ("page_table", page_table, torch.int32)):
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_scale", k_scale), ("v_scale", v_scale),
                    ("page_table", page_table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _library()
    bq, tile_pages = _tiling(lib, block_kv=block_kv, block_q=block_q, S=S,
                             G=H // KV, KV=KV, ps=ps, hd=hd)
    qs = qs.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_kv_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
            qs.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, S, H, KV, hd, ps, NP, bits, _Q_DTYPES[q.dtype],
            _PAGE_DTYPES[k_pages.dtype], bq, tile_pages, int(block_kv),
            float(1.0 / np.sqrt(hd)), stream)
    build.check_launch(lib, "paged_kv_attention", err)
    if block_kv:
        paged_kv_attention_chunk.kvblock_launches += 1
    else:
        paged_kv_attention_chunk.launches += 1
    return out


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel library with its C signatures declared (built on first
    use)."""
    global _lib
    if _lib is None:
        lib = build.load("paged_kv_attention")
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_kv_attention_launch.argtypes = (
            [vp] * 9 + [i] * 13 + [f, vp])
        lib.paged_kv_attention_launch.restype = i
        lib.paged_kv_attention_smem_bytes.argtypes = [i, i, i]
        lib.paged_kv_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_kv_attention_kvblock_smem_bytes.argtypes = [i, i, i, i]
        lib.paged_kv_attention_kvblock_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def paged_kv_attention_chunk(q, k_pages, v_pages, k_scale, v_scale,
                             page_table, q_start, kv_len, *, bits: int = 8,
                             block_q: int = 8,
                             block_kv: bool = False) -> torch.Tensor:
    """Variable-length chunk attention over a paged quantized KV pool.

    q: (B, S, H, hd) float32/bfloat16 — S chunk queries per row (S == 1:
    decode). k_pages/v_pages: (P, ps, KV, hdw) — int8 grid (bits=8), int32
    words of 8 packed 4-bit fields (bits=4, hdw = hd/8), or float (bits=0).
    k_scale/v_scale: (P,) float32 per-page scales. page_table: (B, NP)
    int32; unused entries must name a valid page (the scratch page 0).
    q_start: scalar or (B,) absolute position of each row's first query;
    query i attends keys causally up to ``q_start + i``. kv_len: scalar or
    (B,) valid history length per row including the chunk's real tokens
    (>= 1). ``block_q`` queries share one kernel block. ``block_kv``
    selects the KV-head-blocked kernel (launches counted in
    ``paged_kv_attention_chunk.kvblock_launches``; the default kernel's in
    ``.launches``). Returns (B, S, H, hd) float32; padded query rows past a
    row's real tokens hold values no caller reads.
    """
    _check(q, k_pages, v_pages, k_scale, v_scale, page_table, bits)
    B = q.shape[0]
    qs = per_row(q_start, B, q.device)
    lens = per_row(kv_len, B, q.device)
    if q.device.type == "cpu":
        return paged_kv_attention_chunk_plain(
            q, k_pages, v_pages, k_scale, v_scale, page_table, qs, lens,
            bits=bits)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k_pages, v_pages, k_scale, v_scale, page_table, qs,
                   lens, bits=bits, block_q=block_q, block_kv=block_kv)


paged_kv_attention_chunk.launches = 0
paged_kv_attention_chunk.kvblock_launches = 0


def paged_kv_attention_decode(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, kv_len, *,
                              bits: int = 8) -> torch.Tensor:
    """Decode attention: the S == 1 case of :func:`paged_kv_attention_chunk`
    (the sole query sits at ``kv_len - 1``). q: (B, H, hd). Returns
    (B, H, hd) float32."""
    lens = per_row(kv_len, q.shape[0], q.device)
    out = paged_kv_attention_chunk(q[:, None], k_pages, v_pages, k_scale,
                                   v_scale, page_table, lens - 1, lens,
                                   bits=bits, block_q=1)
    return out[:, 0]
