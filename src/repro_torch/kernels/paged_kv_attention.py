"""GQA variable-length attention over a paged, quantized KV pool — one
kernel for chunked prefill (S >= 1) and decode (S == 1).

Replaces the TPU kernels ``repro/kernels/paged_kv_attention.py::
_chunk_kernel`` (B1) and ``_chunk_kernel_kvblock`` (B2, ``block_kv=True``)
with the hand-written CUDA kernels in ``csrc/paged_kv_attention.cu`` (see
its header for the design). On int8, int4 and bf16 pages both run on
tensor cores (``mma.sync``, exact grid operands, scales outside the MMA),
stage raw page bytes asynchronously and split the keys of a row over
several blocks: :func:`plan_splits` cuts the page-table columns from the
shapes alone, each split writes a partial ``(m, l, acc)`` and a merge
kernel combines them in fixed order (:func:`merge_partials_plain` is its
plain version), so two identical calls are bitwise equal. B2 stages whole
pages, every KV head, so each page is read once per query block. Float32
pages and the shapes the tensor-core kernels do not take go, by explicit
dispatch in :func:`kernel_route`, to the float32-FMA kernels of the same
file; the two routes compute the same function.

:func:`paged_kv_attention_chunk` keeps the reference's signature and
layouts. For CUDA tensors it launches the kernel (and counts the call in
``paged_kv_attention_chunk.launches``, B2's in ``.kvblock_launches``: one
per call, the merge of the splits included, so a served run's count is
layers x programs); for CPU tensors it runs
:func:`paged_kv_attention_chunk_plain`, a page-by-page PyTorch version of
the same arithmetic. It never falls back from one to the other.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

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
# the tensor-core route
_MMA_HEAD_DIMS = (32, 64, 128)
_MMA_PAGE_DTYPES = (torch.int8, torch.int32, torch.bfloat16)
_MAX_WARPS = 8              # B1: 16 query rows per warp, 128 rows a block
_MAX_WARPS_KVBLOCK = 16     # B2 with a bf16 q (8 with a float32 q)
_MIN_SPLIT_KEYS = 64        # no split shorter than this many keys
_MAX_SPLIT_PAGES = 512      # a split's page ids and scales fit shared memory
H100_SMS = 132


def query_block(S: int, G: int, KV: int, block_kv: bool,
                q_dtype=torch.bfloat16) -> int:
    """Queries per block of the tensor-core kernels: as many as fit 128
    rows (bq * G, 16 per warp) for B1; for B2, whose warps cover every KV
    head, 16 rows a head per warp it can give each head out of 16 warps (8
    with a float32 q, whose fragments take three times the shared
    memory)."""
    if not block_kv:
        return max(1, min(S, 16 * _MAX_WARPS // G))
    warps = _MAX_WARPS_KVBLOCK if q_dtype == torch.bfloat16 else _MAX_WARPS
    return max(1, min(S, 16 * max(1, warps // KV) // G))


def kernel_route(k_pages: torch.Tensor, *, head_dim: int, G: int,
                 block_kv: bool) -> str:
    """"mma" (the tensor-core kernels) for int8, int4 and bf16 pages at
    head_dim 32, 64 or 128 within 8 warps of 16 rows; "fma" (the
    float32-FMA kernels) for float32 pages and every other shape."""
    KV = k_pages.shape[2]
    warps = -(-G // 16) * (KV if block_kv else 1)
    if (k_pages.dtype in _MMA_PAGE_DTYPES and head_dim in _MMA_HEAD_DIMS
            and warps <= _MAX_WARPS):
        return "mma"
    return "fma"


@functools.lru_cache(maxsize=256)
def plan_splits(*, B: int, KV: int, S: int, NP: int, ps: int, G: int,
                num_sms: int = H100_SMS, blocks_per_sm=(3, 1),
                q_dtype=torch.bfloat16):
    """Split the NP page-table columns of every row into contiguous ranges
    ``((begin, end), ...)`` from the shapes alone (never from the data, so
    runs repeat bitwise). B1 and B2 take the same plan, so that they agree
    bit for bit: as many splits as fill one wave of the kernel whose grid
    is smaller, given each kernel's resident blocks per SM
    (``blocks_per_sm``: B1's, B2's; None for a kernel that takes the FMA
    route), none shorter than ``_MIN_SPLIT_KEYS`` keys or longer than
    ``_MAX_SPLIT_PAGES`` pages. Every column lies in exactly one split and
    no split is empty."""
    fill = 1
    for block_kv, bps in zip((False, True), blocks_per_sm):
        if bps:
            nq = -(-S // query_block(S, G, KV, block_kv, q_dtype))
            blocks = B * nq * (1 if block_kv else KV)
            fill = max(fill, num_sms * bps // blocks)
    most = max(1, NP // max(1, -(-_MIN_SPLIT_KEYS // ps)))
    n = max(min(fill, most), -(-NP // _MAX_SPLIT_PAGES), 1)
    per = -(-NP // n)
    return tuple((i, min(i + per, NP)) for i in range(0, NP, per))


@functools.lru_cache(maxsize=256)
def _occupancy(H, KV, hd, bits, q_code, page_code, bq, pps, block_kv):
    """(resident blocks per SM, dynamic shared memory bytes per block) of
    the tensor-core kernel at these shapes (CUDA's occupancy calculator
    over its registers, threads and shared memory); raises if the
    configuration cannot launch."""
    lib = _library()
    n, smem = ctypes.c_int(0), ctypes.c_int(0)
    err = lib.paged_kv_attention_blocks_per_sm(
        H, KV, hd, bits, q_code, page_code, bq, pps, int(block_kv),
        ctypes.byref(n), ctypes.byref(smem))
    build.check_launch(lib, "paged_kv_attention", err)
    if n.value < 1:
        raise RuntimeError("paged_kv_attention: the kernel cannot launch at "
                           f"these shapes (H={H}, KV={KV}, hd={hd}, "
                           f"block_q={bq}, block_kv={block_kv})")
    return n.value, smem.value


def _dequant(x: torch.Tensor, scale: torch.Tensor, *, bits: int,
             head_dim: int) -> torch.Tensor:
    """(B, ps, KV, hdw) stored pages, (B,) scales -> (B, ps, KV, hd) f32."""
    if bits == 4:
        x = unpack_bits(x, 4, head_dim)
    return x.to(torch.float32) * scale[:, None, None, None]


def paged_kv_attention_partial_plain(q, k_pages, v_pages, k_scale,
                                     v_scale, page_table, q_start, kv_len,
                                     *, bits: int = 8, pages=None):
    """The online softmax over page-table columns ``pages`` (a range;
    every column by default), one pool page per step: the unnormalised
    partial ``(m, l, acc)`` of one split, (B, S, H) / (B, S, H) /
    (B, S, H, hd) float32. A split whose keys no query sees keeps
    m = -1e30, and a fully masked page adds exp(-1e30 - m) = 0 once m is
    real."""
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
    for p in (range(NP) if pages is None else pages):
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
    return (m.permute(0, 2, 1, 3).reshape(B, S, H),
            l.permute(0, 2, 1, 3).reshape(B, S, H),
            acc.permute(0, 2, 1, 3, 4).reshape(B, S, H, hd))


def paged_kv_attention_chunk_plain(q, k_pages, v_pages, k_scale, v_scale,
                                   page_table, q_start, kv_len, *,
                                   bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same masked online softmax,
    one pool page per step, over every page-table column, normalised.

    (Columns past a row's last visible key add exp(-1e30 - m) = 0 and
    leave the state unchanged, so looping over all of them equals the
    kernel's early stop.) Returns (B, S, H, hd) float32."""
    _, l, acc = paged_kv_attention_partial_plain(
        q, k_pages, v_pages, k_scale, v_scale, page_table, q_start, kv_len,
        bits=bits)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def merge_partials_plain(m, l, acc) -> torch.Tensor:
    """Plain version of the merge kernel: split partials m, l (n, ...) and
    acc (n, ..., hd), combined in split order as M = max m_i,
    L = sum exp(m_i - M) l_i, out = sum exp(m_i - M) acc_i / max(L, 1e-30)."""
    M = m.amax(dim=0)
    w = torch.exp(m - M)
    L = (w * l).sum(dim=0)
    out = (w[..., None] * acc).sum(dim=0)
    return out / torch.clamp(L, min=1e-30)[..., None]


def _rows_i32(x, B: int, device) -> torch.Tensor:
    """A scalar or (B,) integer argument as a contiguous (B,) int32 tensor
    on ``device`` (the kernel's index type), converting at most once."""
    t = torch.as_tensor(x, device=device).reshape(-1)
    t = t if t.dtype == torch.int32 else t.to(torch.int32)
    return t.expand(B).contiguous() if t.numel() == 1 else t.contiguous()


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
    """Launch the CUDA kernel on the current stream (and, with several
    splits, the merge kernel); ``qs``/``lens`` are contiguous (B,) int32.
    Raises on a failed launch."""
    B, S, H, hd = q.shape
    _, ps, KV, _ = k_pages.shape
    NP = page_table.shape[1]
    G = H // KV
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
    route = kernel_route(k_pages, head_dim=hd, G=G, block_kv=block_kv)
    parts = (None, None, None)
    dev_ctx = (contextlib.nullcontext()
               if q.device.index == torch.cuda.current_device()
               else torch.cuda.device(q.device))
    if route == "mma":
        for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary "
                                 "(the kernel copies 16-byte runs)")
        bq = query_block(S, G, KV, block_kv, q.dtype)
        occ = {}                 # both kernels' occupancy: one shared plan
        with dev_ctx:
            for kvb in (False, True):
                if kernel_route(k_pages, head_dim=hd, G=G,
                                block_kv=kvb) == "mma":
                    occ[kvb] = _occupancy(
                        H, KV, hd, bits, _Q_DTYPES[q.dtype],
                        _PAGE_DTYPES[k_pages.dtype],
                        query_block(S, G, KV, kvb, q.dtype),
                        min(NP, _MAX_SPLIT_PAGES), kvb)
        bps, smem = occ[block_kv]
        splits = plan_splits(
            B=B, KV=KV, S=S, NP=NP, ps=ps, G=G,
            num_sms=build.num_sms(q.device.index or 0),
            blocks_per_sm=tuple(occ.get(k, (None,))[0]
                                for k in (False, True)), q_dtype=q.dtype)
        pps, n_splits, tile_pages = splits[0][1], len(splits), 0
        if n_splits > 1:   # one scratch buffer: acc (16-byte aligned), m, l
            rows = n_splits * B * S * H
            buf = torch.empty(rows * (hd + 2), dtype=torch.float32,
                              device=q.device)
            parts = (buf[rows * hd:rows * (hd + 1)], buf[rows * (hd + 1):],
                     buf[:rows * hd])
    else:
        bq, tile_pages = _tiling(lib, block_kv=block_kv, block_q=block_q,
                                 S=S, G=G, KV=KV, ps=ps, hd=hd)
        pps, n_splits, bps, smem = NP, 1, None, None
    out = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    with dev_ctx:
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_kv_attention_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
            qs.data_ptr(), lens.data_ptr(), out.data_ptr(),
            *[0 if t is None else t.data_ptr() for t in parts],
            B, S, H, KV, hd, ps, NP, bits, _Q_DTYPES[q.dtype],
            _PAGE_DTYPES[k_pages.dtype], int(route == "mma"), bq,
            tile_pages, pps, n_splits, int(block_kv),
            float(1.0 / np.sqrt(hd)), stream)
    build.check_launch(lib, "paged_kv_attention", err)
    paged_kv_attention_chunk.last_plan = {
        "route": route, "block_q": bq, "splits": n_splits,
        "blocks_per_sm": bps, "smem_bytes": smem}
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
            [vp] * 12 + [i] * 16 + [f, vp])
        lib.paged_kv_attention_launch.restype = i
        lib.paged_kv_attention_blocks_per_sm.argtypes = [i] * 9 + [vp, vp]
        lib.paged_kv_attention_blocks_per_sm.restype = i
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
    (>= 1). ``block_q`` queries share one block of the float32-FMA kernel
    (the tensor-core kernels choose theirs with :func:`query_block`; the
    reference passes it as a tiling hint). ``block_kv`` selects the
    KV-head-blocked kernel (calls counted in
    ``paged_kv_attention_chunk.kvblock_launches``; the default kernel's in
    ``.launches``; one per call, whatever the splits). Returns
    (B, S, H, hd) float32; padded query rows past a row's real tokens hold
    values no caller reads.
    """
    _check(q, k_pages, v_pages, k_scale, v_scale, page_table, bits)
    B = q.shape[0]
    if q.device.type == "cuda":
        return _launch(q, k_pages, v_pages, k_scale, v_scale, page_table,
                       _rows_i32(q_start, B, q.device),
                       _rows_i32(kv_len, B, q.device), bits=bits,
                       block_q=block_q, block_kv=block_kv)
    qs = per_row(q_start, B, q.device)
    lens = per_row(kv_len, B, q.device)
    if q.device.type == "cpu":
        return paged_kv_attention_chunk_plain(
            q, k_pages, v_pages, k_scale, v_scale, page_table, qs, lens,
            bits=bits)
    raise ValueError(f"no kernel for device {q.device}")


paged_kv_attention_chunk.launches = 0
paged_kv_attention_chunk.kvblock_launches = 0
# the last launch: route ("mma" or "fma"), query block, KV splits, and the
# resident blocks per SM the planner was given and the dynamic shared
# memory per block (None on the FMA route)
paged_kv_attention_chunk.last_plan = None


def paged_kv_attention_decode(q, k_pages, v_pages, k_scale, v_scale,
                              page_table, kv_len, *,
                              bits: int = 8) -> torch.Tensor:
    """Decode attention: the S == 1 case of :func:`paged_kv_attention_chunk`
    (the sole query sits at ``kv_len - 1``). q: (B, H, hd). Returns
    (B, H, hd) float32."""
    lens = (_rows_i32 if q.is_cuda else per_row)(kv_len, q.shape[0],
                                                  q.device)
    out = paged_kv_attention_chunk(q[:, None], k_pages, v_pages, k_scale,
                                   v_scale, page_table, lens - 1, lens,
                                   bits=bits, block_q=1)
    return out[:, 0]
