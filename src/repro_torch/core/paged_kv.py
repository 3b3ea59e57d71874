"""Paged quantized KV cache: page pools, the host-side page allocator, and
the device-side write (quantize, pack, scatter) and gather.

The cache is a pool of fixed-size pages shared by all sequences; a
per-sequence page table maps logical token positions to pool pages. Each
page stores its tokens in a container:

* ``"int8"`` — the int8 integer grid of the layer's Q(I,F) format;
* ``"int4"`` — a 4-bit grid lane-packed 8 values per int32 word along the
  head dim (:func:`repro_torch.core.qtensor.pack_bits`);
* ``"fp"``   — unquantized pages in the compute dtype.

Each page carries a dequant scale (value = grid * scale). Page 0 is the
scratch page: idle slots and padded chunk tails write there, and the
allocator never hands it out.

Unlike the reference's functional ``.at[].set``, :func:`paged_update` writes
the pool tensors IN PLACE (index_put) and returns the same dict: a
full-width pool is tens of MB per layer, and copying it per token would
dominate decode. ``scale_mode="page"`` (per-page max-abs calibration),
``copy_pool_pages`` and the pool traversal helpers of the reference are
still to port (ROADMAP queue A items 3 and 8).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..runtime.telemetry import MetricsRegistry
from .fixedpoint import format_params
from .qtensor import pack_bits, unpack_bits, values_per_word

SCRATCH_PAGE = 0

_CONTAINERS = ("int8", "int4", "fp")


class OutOfPagesError(RuntimeError):
    """A request's page demand cannot be backed by the pool.

    Raised before any page is handed out (admission preflight) or when the
    free list empties mid-run, with the counts needed to size
    ``--num-pages``: ``reserved`` pages are promised to live requests but
    not yet written, ``written`` pages already hold live KV."""

    def __init__(self, *, needed: int, free: int, total: int,
                 rid: Optional[int] = None, reserved: int = 0,
                 written: int = 0):
        self.needed, self.free, self.total, self.rid = needed, free, total, rid
        self.reserved, self.written = reserved, written
        who = f"request {rid}" if rid is not None else "allocation"
        extra = ""
        if reserved or written:
            extra = f" [{written} written, {reserved} reserved-unwritten]"
        super().__init__(
            f"KV page pool cannot back {who}: needs {needed} page(s), "
            f"{free} free of {total} usable (page 0 is scratch){extra}; "
            f"raise --num-pages, shrink --max-new, or lower concurrency")


@dataclasses.dataclass(frozen=True)
class PagedCacheSpec:
    """Pool geometry shared by every attention layer. ``num_pages``
    includes the scratch page 0."""

    page_size: int
    num_pages: int

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        if self.num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")


@dataclasses.dataclass(frozen=True)
class PagedKVLayout:
    """Static shape/dtype description of one layer's paged KV pool."""

    num_pages: int          # pool pages, including the scratch page
    page_size: int          # tokens per page
    num_kv_heads: int
    head_dim: int
    container: str = "int8"
    dtype: torch.dtype = torch.float32  # storage dtype for container="fp"

    def __post_init__(self):
        if self.container not in _CONTAINERS:
            raise ValueError(f"container must be one of {_CONTAINERS}, "
                             f"got {self.container!r}")
        if self.container == "int4" and self.head_dim % values_per_word(4):
            raise ValueError("int4 packing needs head_dim % 8 == 0, got "
                             f"{self.head_dim}")
        if self.num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")

    @property
    def store_head_dim(self) -> int:
        """Last-dim extent of the stored page (packed for int4)."""
        if self.container == "int4":
            return self.head_dim // values_per_word(4)
        return self.head_dim

    @property
    def store_dtype(self) -> torch.dtype:
        return {"int8": torch.int8, "int4": torch.int32,
                "fp": self.dtype}[self.container]


def max_pages_per_seq(max_len: int, page_size: int) -> int:
    return -(-max_len // page_size)


# ---------------------------------------------------------------------------
# Host-side page allocator
# ---------------------------------------------------------------------------
class PageAllocator:
    """Refcounted free-list allocator over pages 1..num_pages-1 (0: scratch).

    Host-side bookkeeping only: ``alloc`` hands out an index at refcount 1,
    ``incref`` adds a reference, ``free`` releases one reference per page
    and recycles pages that reach zero; releasing a page twice raises.
    ``metrics`` counts allocations ("alloc.allocs") and registers a live
    "alloc.free_pages" gauge. The reference's reclaim/pressure hooks serve
    the prefix cache and are still to port (ROADMAP queue A item 8)."""

    def __init__(self, num_pages: int, *,
                 metrics: Optional[MetricsRegistry] = None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_allocs = self.metrics.counter("alloc.allocs")
        self.metrics.register_gauge("alloc.free_pages", lambda: len(self._free))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_usable(self) -> int:
        return self.num_pages - 1

    def refcount(self, page: int) -> int:
        """Live references on ``page`` (0 = free / never allocated)."""
        return self._refs.get(page, 0)

    def alloc(self) -> int:
        if not self._free:
            raise OutOfPagesError(needed=1, free=0, total=self.num_usable)
        page = self._free.pop()
        self._refs[page] = 1
        self._c_allocs.inc()
        return page

    def incref(self, page: int) -> None:
        if self._refs.get(page, 0) <= 0:
            raise ValueError(f"incref of unallocated page {page}")
        self._refs[page] += 1

    def free(self, pages: Sequence[int]) -> None:
        """Release ONE reference per page; recycle pages that hit zero."""
        for p in pages:
            if not (0 < p < self.num_pages):
                raise ValueError(f"freeing invalid page id {p}")
            refs = self._refs.get(p, 0)
            if refs <= 0:
                raise ValueError(f"double free of page {p}")
            if refs == 1:
                del self._refs[p]
                self._free.append(p)
            else:
                self._refs[p] = refs - 1


# ---------------------------------------------------------------------------
# Device-side pool ops
# ---------------------------------------------------------------------------
def init_paged_pool(layout: PagedKVLayout,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """One layer's paged pool: k/v pages + per-page dequant scales."""
    shape = (layout.num_pages, layout.page_size, layout.num_kv_heads,
             layout.store_head_dim)
    return {
        "k_pages": torch.zeros(shape, dtype=layout.store_dtype, device=device),
        "v_pages": torch.zeros(shape, dtype=layout.store_dtype, device=device),
        "k_scale": torch.ones((layout.num_pages,), dtype=torch.float32,
                              device=device),
        "v_scale": torch.ones((layout.num_pages,), dtype=torch.float32,
                              device=device),
    }


def per_row(x, B: int, device) -> torch.Tensor:
    """A scalar or (B,) integer argument as a (B,) int64 tensor."""
    t = torch.as_tensor(x, device=device).reshape(-1).to(torch.int64)
    return t.expand(B) if t.numel() == 1 else t


def _quant_grid(x: torch.Tensor, int_bits: int, frac_bits: int):
    """float (..., hd) -> (integer grid as float32, reciprocal scale).

    ``torch.round`` rounds half to even, as ``jnp.round`` does at this call
    site of the reference (``trunc(x + copysign(.5, x))`` would not)."""
    scale, qmin, qmax = format_params(int_bits, frac_bits)
    q = torch.clamp(torch.round(x.to(torch.float32) * scale), qmin, qmax)
    return q, 1.0 / scale


def _pack_grid(q: torch.Tensor, bits: int) -> torch.Tensor:
    packed, _ = pack_bits(q.to(torch.int32), bits)
    return packed


def paged_update(pool, k_new, v_new, page_table, pos, *, page_size: int,
                 container: str = "int8", int_bits=None, frac_bits=None,
                 valid_len=None, scale_mode: str = "static"):
    """Append S new tokens per sequence to the paged pool, in place.

    k_new/v_new: (B, S, KV, hd) float; page_table: (B, NP) int32; pos: scalar
    or (B,) — the logical position of the FIRST new token per sequence.
    ``valid_len`` (scalar or (B,)) marks only the first ``valid_len`` of the
    S tokens as real: the padded rest writes to the scratch page. Tokens
    past the page-table span clamp into the row's last page, as in the
    reference. Returns ``pool`` (updated in place).

    Static scale mode: every touched page's scale becomes the layer's
    uniform Q(I,F) step 2^-F. Float pages store raw values under a unit
    scale, reset on each page's first write (offset 0). Distinct sequences
    own distinct pages, so duplicate scatter indices only ever land on the
    scratch page, where any write order is acceptable.
    """
    B, S = k_new.shape[0], k_new.shape[1]
    dev = k_new.device
    pos = per_row(pos, B, dev)
    ar = torch.arange(S, device=dev)
    positions = pos[:, None] + ar[None, :]                 # (B, S)
    blocks = torch.clamp(positions // page_size, max=page_table.shape[1] - 1)
    offsets = positions % page_size
    pids = torch.gather(page_table.to(torch.int64), 1, blocks)
    if valid_len is not None:
        vl = per_row(valid_len, B, dev)
        pids = torch.where(ar[None, :] < vl[:, None], pids,
                           torch.full_like(pids, SCRATCH_PAGE))

    if container == "fp":
        first = torch.where(offsets == 0, pids,
                            torch.full_like(pids, SCRATCH_PAGE))
        pool["k_pages"][pids, offsets] = k_new.to(pool["k_pages"].dtype)
        pool["v_pages"][pids, offsets] = v_new.to(pool["v_pages"].dtype)
        pool["k_scale"][first] = 1.0
        pool["v_scale"][first] = 1.0
        return pool

    if scale_mode == "page":
        raise NotImplementedError(
            "per-page scale calibration (--kv-scale page) is not ported "
            "yet: ROADMAP queue A item 8")
    if scale_mode != "static":
        raise ValueError(f"scale_mode must be 'static' or 'page', "
                         f"got {scale_mode!r}")
    k_q, rscale = _quant_grid(k_new, int_bits, frac_bits)
    v_q, _ = _quant_grid(v_new, int_bits, frac_bits)
    if container == "int4":
        k_q, v_q = _pack_grid(k_q, 4), _pack_grid(v_q, 4)
    pool["k_pages"][pids, offsets] = k_q.to(pool["k_pages"].dtype)
    pool["v_pages"][pids, offsets] = v_q.to(pool["v_pages"].dtype)
    pool["k_scale"][pids] = rscale
    pool["v_scale"][pids] = rscale
    return pool


def paged_gather(pool, page_table, *, container: str = "int8",
                 head_dim: Optional[int] = None, dtype=torch.float32):
    """Materialize the logical dense cache view (B, NP*ps, KV, hd).

    Gathers each sequence's pages and dequantizes with the per-page scales
    (float pages keep unit scales). The plain path the attention kernel is
    checked against; the kernel never materializes this view."""
    pt = page_table.to(torch.int64)
    kg = pool["k_pages"][pt]              # (B, NP, ps, KV, hdw)
    vg = pool["v_pages"][pt]
    ks = pool["k_scale"][pt]              # (B, NP)
    vs = pool["v_scale"][pt]
    B, NP, ps, KV = kg.shape[:4]
    if container == "int4":
        if head_dim is None:
            raise ValueError("int4 pages need head_dim to unpack")
        kg = unpack_bits(kg, 4, head_dim)
        vg = unpack_bits(vg, 4, head_dim)
    k = (kg.to(torch.float32) * ks[:, :, None, None, None]).to(dtype)
    v = (vg.to(torch.float32) * vs[:, :, None, None, None]).to(dtype)
    hd = k.shape[-1]
    return k.reshape(B, NP * ps, KV, hd), v.reshape(B, NP * ps, KV, hd)


def pool_container(pool) -> str:
    """Container name of a pool dict, inferred from the stored dtype."""
    dt = pool["k_pages"].dtype
    if dt.is_floating_point:
        return "fp"
    return "int8" if dt == torch.int8 else "int4"


def pool_bytes(pool) -> int:
    """True stored bytes of one layer's pool (pages + scales)."""
    return sum(t.numel() * t.element_size() for t in pool.values())


def caches_kv_bytes(caches) -> Dict[str, int]:
    """Device bytes of every layer's pool, split per container. ``caches``
    is the port's per-layer list of pool dicts."""
    out: Dict[str, int] = {}
    for pool in caches:
        cont = pool_container(pool)
        out[cont] = out.get(cont, 0) + pool_bytes(pool)
    return out
