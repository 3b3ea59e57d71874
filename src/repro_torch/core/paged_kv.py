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
dominate decode. ``scale_mode="page"`` calibrates each page's scale to
the max-abs of what was written to it and requantizes the page in place
when the scale rises; ``copy_pool_pages`` is the prefix cache's
copy-on-write, ``iter_kv_pools``/``map_kv_pools`` walk a model's
per-layer pools, and ``kv_pool_groups`` groups them as the reference's
scan-stacked pools (the tiered page store's record layout).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

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
    not yet written, ``written`` pages already hold live KV, ``evictable``
    unreferenced prefix-cache pages could be reclaimed, ``requantizable``
    cold cached pages the quant tier could narrow in place, and
    ``host_pages`` pages are parked in the host tier."""

    def __init__(self, *, needed: int, free: int, total: int,
                 rid: Optional[int] = None, reserved: int = 0,
                 written: int = 0, evictable: int = 0,
                 requantizable: int = 0, host_pages: int = 0):
        self.needed, self.free, self.total, self.rid = needed, free, total, rid
        self.reserved, self.written = reserved, written
        self.evictable = evictable
        self.requantizable = requantizable
        self.host_pages = host_pages
        who = f"request {rid}" if rid is not None else "allocation"
        extra = ""
        if reserved or written or evictable or requantizable or host_pages:
            extra = (f" [{written} written, {reserved} reserved-unwritten, "
                     f"{evictable} evictable-cached, "
                     f"{requantizable} requantizable, "
                     f"{host_pages} host-tier]")
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
    ``reclaim`` (optional ``n_pages -> n_freed``) is called when the free
    list is empty at ``alloc``: the prefix cache registers its eviction
    there (requantize, demote to the host tier, or drop). ``pressure`` is a
    list of further callbacks of the same contract (``add_pressure``),
    tried in order after ``reclaim``. ``host_inventory`` and
    ``requant_inventory`` (optional zero-arg callables -> page count) let
    :class:`OutOfPagesError` report the host tier and the pages the quant
    tier could narrow. ``metrics`` counts allocations ("alloc.allocs") and
    pressure calls ("alloc.reclaims"), and registers a live
    "alloc.free_pages" gauge."""

    def __init__(self, num_pages: int, *,
                 metrics: Optional[MetricsRegistry] = None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        self.reclaim: Optional[Callable[[int], int]] = None
        self.pressure: List[Callable[[int], int]] = []
        self.host_inventory: Optional[Callable[[], int]] = None
        self.requant_inventory: Optional[Callable[[], int]] = None
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c_allocs = self.metrics.counter("alloc.allocs")
        self._c_reclaims = self.metrics.counter("alloc.reclaims")
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

    def host_pages(self) -> int:
        """Pages currently parked in the host tier (0 without a tier)."""
        return int(self.host_inventory()) if self.host_inventory else 0

    def requant_pages(self) -> int:
        """Cold cached pages the quant tier could narrow in place (0
        without an adaptation tier)."""
        return (int(self.requant_inventory())
                if self.requant_inventory else 0)

    def add_pressure(self, fn: Callable[[int], int]) -> None:
        """Register an ``n_pages -> n_freed`` pressure callback (tried after
        ``reclaim`` when the free list empties mid-``alloc``)."""
        self.pressure.append(fn)

    def _apply_pressure(self, needed: int) -> None:
        if self._free:
            return
        self._c_reclaims.inc()
        if self.reclaim is not None:
            self.reclaim(needed)
        for fn in self.pressure:
            if self._free:
                return
            fn(needed)

    def alloc(self) -> int:
        if not self._free:
            self._apply_pressure(1)
        if not self._free:
            raise OutOfPagesError(needed=1, free=0, total=self.num_usable,
                                  requantizable=self.requant_pages(),
                                  host_pages=self.host_pages())
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
    past the page-table span clamp into the row's last page in static
    mode and go to the scratch page in page mode, as in the reference.
    Returns ``pool`` (updated in place).

    Static scale mode: every touched page's scale becomes the layer's
    uniform Q(I,F) step 2^-F. Page mode (int containers): each page's
    scale is the running max-abs of what was written to it over the
    container's symmetric grid (:func:`_paged_update_page_scale`). Float
    pages store raw values under a unit scale, reset on each page's first
    write (offset 0). Distinct sequences own distinct pages (pages shared
    through the prefix cache lie before every sharer's write position), so
    duplicate scatter indices only ever land on the scratch page, where
    any write order is acceptable.
    """
    B, S = k_new.shape[0], k_new.shape[1]
    dev = k_new.device
    pos = per_row(pos, B, dev)
    ar = torch.arange(S, device=dev)
    positions = pos[:, None] + ar[None, :]                 # (B, S)
    blocks = torch.clamp(positions // page_size, max=page_table.shape[1] - 1)
    offsets = positions % page_size
    pids = torch.gather(page_table.to(torch.int64), 1, blocks)
    valid = torch.ones((B, S), dtype=torch.bool, device=dev)
    if valid_len is not None:
        vl = per_row(valid_len, B, dev)
        valid = ar[None, :] < vl[:, None]
        pids = torch.where(valid, pids, torch.full_like(pids, SCRATCH_PAGE))

    if container == "fp":
        first = torch.where(offsets == 0, pids,
                            torch.full_like(pids, SCRATCH_PAGE))
        pool["k_pages"][pids, offsets] = k_new.to(pool["k_pages"].dtype)
        pool["v_pages"][pids, offsets] = v_new.to(pool["v_pages"].dtype)
        pool["k_scale"][first] = 1.0
        pool["v_scale"][first] = 1.0
        return pool

    if scale_mode == "page":
        return _paged_update_page_scale(
            pool, k_new, v_new, page_table, pos, pids, offsets, valid,
            page_size=page_size, container=container)
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


_SCALE_EPS = 2.0 ** -20   # floor for all-zero chunks (no division by 0)


def _paged_update_page_scale(pool, k_new, v_new, page_table, pos, pids,
                             offsets, valid, *, page_size: int,
                             container: str):
    """Per-page max-abs calibrated write (``scale_mode="page"``), in place.

    A chunk's positions are contiguous, so each row touches at most
    ``nb = (S - 1) // ps + 2`` consecutive blocks. Those pages are gathered,
    requantized under the (possibly raised) new scale and written back,
    then the new tokens are written, then the scales: this order matters
    because the writes are in place. A block is fresh when it is not the
    row's first block or the chunk starts at its offset 0; a fresh block's
    old scale and content (a recycled page's garbage) are ignored. Tokens
    past the page-table span, and blocks past it, go to the scratch page.
    Rounding is ``torch.round`` (half to even, the reference's
    ``jnp.round``), and new tokens are divided by their page's scale.

    SHARING CONTRACT: a scale raise rewrites the touched pages' grids, so
    every page in a row's written block range must be held by that row
    alone (refcount 1). The server keeps it: in page mode the prefix cache
    never holds a page its owner still writes, and
    ``BatchedServer._ensure_page`` asserts refcount 1 on the target block.
    """
    B, S = k_new.shape[0], k_new.shape[1]
    ps, NP = page_size, page_table.shape[1]
    dev = k_new.device
    bits = {"int8": 8, "int4": 4}[container]
    qmax = float(2 ** (bits - 1) - 1)
    hd = k_new.shape[-1]
    pt = page_table.to(torch.int64)
    scratch = torch.full_like(pids, SCRATCH_PAGE)

    nb = (S - 1) // ps + 2
    blk_first = pos // ps                                    # (B,)
    positions = pos[:, None] + torch.arange(S, device=dev)[None, :]
    in_tok = positions // ps < NP                            # (B, S)
    pids = torch.where(in_tok, pids, scratch)
    ar_nb = torch.arange(nb, device=dev)[None, :]
    blocks_nb = blk_first[:, None] + ar_nb                   # (B, nb)
    pids_nb = torch.gather(pt, 1, torch.clamp(blocks_nb, max=NP - 1))
    pids_nb = torch.where(blocks_nb < NP, pids_nb,
                          torch.full_like(pids_nb, SCRATCH_PAGE))
    fresh = (ar_nb > 0) | ((pos % ps) == 0)[:, None]         # (B, nb)
    lb = torch.clamp(positions // ps - blk_first[:, None], 0, nb - 1)

    def page_scales(x_new, old_scale):
        amax = x_new.to(torch.float32).abs().amax(dim=(-2, -1))  # (B, S)
        amax = torch.where(valid & in_tok, amax, torch.zeros_like(amax))
        need = torch.zeros((B, nb), dtype=torch.float32, device=dev)
        need.scatter_reduce_(1, lb, amax, reduce="amax", include_self=True)
        # a tensor divisor: CUDA divides by a Python scalar as a multiply by
        # its reciprocal, which is an ULP off the reference's division
        need = need / torch.full_like(need, qmax)
        old = old_scale[pids_nb]                                 # (B, nb)
        new = torch.maximum(torch.where(fresh, torch.zeros_like(old), old),
                            torch.clamp(need, min=_SCALE_EPS))
        ratio = torch.where(fresh, torch.ones_like(old), old / new)
        return new, ratio

    def requant_and_write(pages, scale, x_new, new_scale, ratio):
        got = pages[pids_nb]                       # (B, nb, ps, KV, hdw)
        if container == "int4":
            got = unpack_bits(got, 4, hd)
        re = torch.round(got.to(torch.float32)
                         * ratio[:, :, None, None, None])
        re = torch.clamp(re, -qmax, qmax)
        sc_tok = torch.gather(new_scale, 1, lb)    # (B, S) token's scale
        q = torch.clamp(torch.round(x_new.to(torch.float32)
                                    / sc_tok[:, :, None, None]),
                        -qmax, qmax)
        if container == "int4":
            re, q = _pack_grid(re, 4), _pack_grid(q, 4)
        pages[pids_nb] = re.to(pages.dtype)
        pages[pids, offsets] = q.to(pages.dtype)
        scale[pids_nb] = new_scale

    k_ns, k_ratio = page_scales(k_new, pool["k_scale"])
    v_ns, v_ratio = page_scales(v_new, pool["v_scale"])
    requant_and_write(pool["k_pages"], pool["k_scale"], k_new, k_ns, k_ratio)
    requant_and_write(pool["v_pages"], pool["v_scale"], v_new, v_ns, v_ratio)
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


def copy_pool_pages(pool, src: int, dst: int):
    """Copy one page's stored bytes and scales ``src -> dst`` in place (the
    prefix cache's copy-on-write: a request that diverges inside a shared
    page extends a private copy, and the source stays byte-identical for
    its other readers). The reference's ``page_axis`` has no counterpart:
    the port keeps one unstacked pool per layer.

    A float pool folds the source scale into the copied floats (in
    float32, then cast to the pool dtype) and gives the copy a unit scale,
    since the copier's later float writes store raw values under a unit
    scale. Int pools copy bytes and scales verbatim. Returns ``pool``."""
    if pool_container(pool) == "fp":
        for pk, sk in (("k_pages", "k_scale"), ("v_pages", "v_scale")):
            pages, scale = pool[pk], pool[sk]
            vals = pages[src].to(torch.float32) * scale[src]
            pages[dst] = vals.to(pages.dtype)
            scale[dst] = 1.0
        return pool
    for t in pool.values():
        t[dst] = t[src]
    return pool


def pool_container(pool) -> str:
    """Container name of a pool dict, inferred from the stored dtype."""
    dt = pool["k_pages"].dtype
    if dt.is_floating_point:
        return "fp"
    return "int8" if dt == torch.int8 else "int4"


def pool_bytes(pool) -> int:
    """True stored bytes of one layer's pool (pages + scales)."""
    return sum(t.numel() * t.element_size() for t in pool.values())


# ---------------------------------------------------------------------------
# Full-model cache traversal
# ---------------------------------------------------------------------------
def iter_kv_pools(caches) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield every paged pool of a model's cache
    (:func:`models.transformer.init_cache`'s per-layer list), in layer
    order; dense slabs are skipped. The port has no scan-stacked pools, so
    unlike the reference it yields no page axis."""
    for entry in caches:
        if isinstance(entry, dict) and "k_pages" in entry:
            yield entry


def map_kv_pools(caches, fn):
    """A model cache with every paged pool replaced by ``fn(pool)``; other
    entries pass through. Order as :func:`iter_kv_pools`."""
    return [fn(c) if isinstance(c, dict) and "k_pages" in c else c
            for c in caches]


def kv_pool_groups(caches, scan: str = "group"
                   ) -> List[Tuple[List[Dict[str, torch.Tensor]], int]]:
    """The per-layer pools grouped as the reference's cache structure
    stacks them, for the dense decoders the port serves (one layer
    segment): ``(pools, page_axis)`` per reference pool, in its traversal
    order. ``scan="group"`` stacks each run of consecutive layers whose
    pools share container, dtype and shape (a uniform cache is one run),
    page axis 1 of the stacked ``(layers, pages, ...)`` pool;
    ``scan="unroll"`` (the reference's ``--kv-profile-scan unroll`` with a
    per-layer profile) keeps one unstacked pool per layer, page axis 0.
    The tiered page store keys its records and snapshots by this grouping,
    so a page moves between the two packages byte for byte."""
    if scan not in ("group", "unroll"):
        raise ValueError(f"scan must be 'group' or 'unroll', got {scan!r}")
    groups: List[Tuple[List[Dict[str, torch.Tensor]], int]] = []
    for pool in iter_kv_pools(caches):
        sig = (pool["k_pages"].dtype, tuple(pool["k_pages"].shape))
        if scan == "unroll":
            groups.append(([pool], 0))
        elif groups and (groups[-1][0][0]["k_pages"].dtype,
                         tuple(groups[-1][0][0]["k_pages"].shape)) == sig:
            groups[-1][0].append(pool)
        else:
            groups.append(([pool], 1))
    return groups


def caches_kv_bytes(caches) -> Dict[str, int]:
    """Device at-rest bytes of every paged pool, split per container."""
    out: Dict[str, int] = {}
    for pool in iter_kv_pools(caches):
        cont = pool_container(pool)
        out[cont] = out.get(cont, 0) + pool_bytes(pool)
    return out
