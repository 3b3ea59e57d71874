"""Tiered KV page store: host-memory offload, the online requantization
tier, and persistent prefix pages.

The device page pool (:mod:`repro_torch.core.paged_kv`) bounds memory
bluntly: when it fills, requests defer and evicted cached prefixes are
destroyed. This module adds the tiers the bound can spill into and refill
from:

* :func:`extract_page` / :func:`inject_page` move ONE logical page between
  the device pools and host numpy. Bytes stay in their storage containers
  (int8 grids, int4 lane-packed int32 words, float pages) with the per-page
  scales, so offload traffic scales with the precision policy, and a
  demote -> promote round trip is byte for byte.
* :class:`HostPageStore` is the bounded host tier: handle-keyed
  :class:`PageBlob` records with page and byte accounting per container.
* :class:`TieredPager` binds an allocator, a host store and the server's
  caches into demote / offload / promote. In async mode a demote clones
  the page on the compute stream, copies the clone into one of a bounded
  ring of pinned host buffers on a side stream, and frees the device page
  at once; the copy resolves at the next drain into ordinary host memory,
  so pinned memory is bounded by the transfers in flight, not by the
  host tier. A prefetch uploads a parked page through pinned memory on the
  side stream ahead of its promote (or of a preempted request's resume).
* :func:`requantize_page` / :class:`QuantTierStore`: under pool pressure a
  cold page is repacked one container step narrower (fp -> int8 -> int4)
  with freshly calibrated per-page scales, on the host in float32 numpy as
  the reference does, and parked on the device in a byte-bounded tier;
  :func:`widen_blob` brings it back into the pools' own containers.
* :func:`save_prefix_snapshot` / :func:`load_prefix_snapshot` persist
  cached chains (token paths and blobs) across restarts, namespaced by the
  KV profile key, with a pool-geometry signature.

Record layout. A blob holds one record per pool of the REFERENCE's cache
structure (``paged_kv.kv_pool_groups``): the port keeps one pool per layer,
the reference stacks runs of same-container layers ``(layers, pages, ...)``,
so a record of a stacked group holds every layer of that group, and the
``.npz`` keys, geometry string and byte counts are the reference's. numpy
has no bfloat16: a bf16 page lives on the host as its 2-byte patterns,
numpy's ``V2`` (the dtype an ``.npz`` written by the reference holds), read
as float pages (container "fp") and reinterpreted as ``torch.bfloat16`` on
upload. Every write into the pools is in place; ``inject_page`` returns the
same cache list.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..runtime.telemetry import Ewma, MetricsRegistry, metric_attr
from .paged_kv import _SCALE_EPS, kv_pool_groups, pool_container
from .qtensor import pack_bits, unpack_bits, values_per_word

__all__ = ["PageBlob", "PendingPageBlob", "HostPageStore", "TieredPager",
           "QuantTierStore", "extract_page", "extract_page_async",
           "inject_page", "requantize_page", "requantize_blob", "widen_blob",
           "narrower_container", "cache_geometry", "snapshot_path",
           "save_prefix_snapshot", "load_prefix_snapshot"]

_FIELDS = ("k", "v", "ks", "vs")
_POOL_KEY = {"k": "k_pages", "v": "v_pages", "ks": "k_scale",
             "vs": "v_scale"}
_BF16 = np.dtype("V2")            # a bf16 page's 2-byte patterns on the host
_NP_NAME = {torch.int8: "int8", torch.int32: "int32",
            torch.float32: "float32", torch.bfloat16: "bfloat16",
            torch.float16: "float16"}


# ---------------------------------------------------------------------------
# host <-> torch conversion
# ---------------------------------------------------------------------------
def _host(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as numpy, without a copy (bf16 as ``V2``)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16)
    return t.numpy()


def to_host(t: torch.Tensor) -> np.ndarray:
    """A private host numpy copy of ``t`` (bf16 as its ``V2`` patterns)."""
    return _host(t.detach().to("cpu", copy=True))


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A host record array as a CPU tensor (``V2`` as ``torch.bfloat16``)."""
    a = np.asarray(a)          # a 0-d scale may arrive as a numpy scalar
    if not a.flags.c_contiguous:
        a = a.copy()
    if a.dtype == _BF16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _container(dt) -> str:
    """Storage container of a numpy or torch dtype (float or bf16 patterns
    -> fp, int8 -> int8, packed int32 words -> int4)."""
    if isinstance(dt, torch.dtype):
        if dt.is_floating_point:
            return "fp"
        return "int8" if dt == torch.int8 else "int4"
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.floating) or dt == _BF16:
        return "fp"
    return "int8" if dt == np.dtype(np.int8) else "int4"


def _float32(a: np.ndarray) -> np.ndarray:
    """Record values as float32 (bf16 patterns widened exactly)."""
    if a.dtype == _BF16:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def _records_bytes_by_container(records) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for rec in records:
        cont = _container(rec["k"].dtype)
        out[cont] = out.get(cont, 0) + int(rec["k"].nbytes + rec["v"].nbytes)
    return out


@dataclasses.dataclass
class PageBlob:
    """Host copy of ONE logical page across every pool record.

    ``arrays[i]`` holds the page's k/v bytes and k/v scales of the i-th
    record of ``paged_kv.kv_pool_groups`` (a stacked group's record carries
    a leading layer dim). Arrays keep the storage dtype."""

    arrays: List[Dict[str, np.ndarray]]

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for rec in self.arrays
                   for a in rec.values())

    def bytes_by_container(self) -> Dict[str, int]:
        """Page (k+v) bytes per storage container; the per-page scales are
        counted in ``nbytes`` only."""
        return _records_bytes_by_container(self.arrays)


def _page_records(caches, page: int,
                  scan: str) -> List[Dict[str, torch.Tensor]]:
    """Fresh device copies of logical ``page`` of every pool record: a
    stacked group's layers are stacked (a new tensor), an unstacked pool's
    page is cloned. They are taken on the current stream, so later in-place
    pool writes cannot reach them."""
    recs = []
    for pools, axis in kv_pool_groups(caches, scan):
        if axis == 1:
            recs.append({f: torch.stack([p[k][page] for p in pools])
                         for f, k in _POOL_KEY.items()})
        else:
            recs.append({f: pools[0][k][page].clone()
                         for f, k in _POOL_KEY.items()})
    return recs


def extract_page(caches, page: int, *, scan: str = "group") -> PageBlob:
    """Copy logical ``page``'s stored bytes and scales out of every pool to
    host numpy. Non-destructive; the blob stays valid after the page is
    freed and rewritten."""
    return PageBlob([{f: to_host(t) for f, t in rec.items()}
                     for rec in _page_records(caches, page, scan)])


class PendingPageBlob:
    """An in-flight device -> host copy of one logical page.

    Holds the host buffers (pinned on a card) with the copies already
    issued on a side stream, and the event recorded after them;
    ``resolve()`` waits on that event and copies the buffers into a
    :class:`PageBlob` of ordinary host memory (idempotent), after which
    the buffers may be reused. ``nbytes`` and ``bytes_by_container`` come
    from shapes and dtypes without waiting, so host-tier accounting stays
    exact while the copy runs behind decode."""

    __slots__ = ("_host", "_done", "_blob")

    def __init__(self, host_records: List[Dict[str, torch.Tensor]],
                 done: Optional["torch.cuda.Event"]):
        self._host = host_records
        self._done = done
        self._blob: Optional[PageBlob] = None

    @property
    def resolved(self) -> bool:
        return self._blob is not None

    def resolve(self) -> PageBlob:
        if self._blob is None:
            if self._done is not None:
                self._done.synchronize()
            self._blob = PageBlob([{f: _host(t).copy()
                                    for f, t in rec.items()}
                                   for rec in self._host])
            self._host = self._done = None
        return self._blob

    @property
    def arrays(self):
        return self.resolve().arrays

    @property
    def nbytes(self) -> int:
        if self._blob is not None:
            return self._blob.nbytes
        return sum(int(t.nbytes) for rec in self._host for t in rec.values())

    def bytes_by_container(self) -> Dict[str, int]:
        if self._blob is not None:
            return self._blob.bytes_by_container()
        return _records_bytes_by_container(self._host)


def _pinned_records(caches, *, scan: str = "group"
                   ) -> List[Dict[str, torch.Tensor]]:
    """Pinned host buffers shaped like one page's records: the landing
    place of an async device -> host page copy."""
    return [{f: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for f, t in rec.items()}
            for rec in _page_records(caches, 0, scan)]


def extract_page_async(caches, page: int, *, scan: str = "group",
                       stream: Optional["torch.cuda.Stream"] = None,
                       buffers: Optional[List[Dict[str, torch.Tensor]]]
                       = None) -> PendingPageBlob:
    """Start copying logical ``page`` to the host without blocking.

    The page is first copied on the device, on the current (compute)
    stream: the pools are written in place, so a view would read the next
    owner's bytes once the page is freed. On a card the copies then go to
    pinned host ``buffers`` (:func:`_pinned_records`, made here when not
    given; the caller must not reuse them before the blob resolves) on
    ``stream`` (a side stream, made here when not given), which waits on
    an event recorded after the device copies; the device copies are
    marked used on that stream (``record_stream``) so the allocator cannot
    hand their memory out before the transfer ends. On the CPU the device
    copies are the host buffers. Byte for byte :func:`extract_page` once
    resolved."""
    recs = _page_records(caches, page, scan)
    dev = recs[0]["k"].device
    if dev.type != "cuda":
        return PendingPageBlob(recs, None)
    side = stream if stream is not None else torch.cuda.Stream(dev)
    host = (buffers if buffers is not None
            else _pinned_records(caches, scan=scan))
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        side.wait_event(ready)
        for rec, out in zip(recs, host):
            for f, t in rec.items():
                out[f].copy_(t, non_blocking=True)
                t.record_stream(side)
        done = torch.cuda.Event()
        done.record(side)
    return PendingPageBlob(host, done)


def _as_tensor(a, ref: torch.Tensor) -> torch.Tensor:
    """A record array (numpy or tensor) on ``ref``'s device and dtype."""
    t = a if isinstance(a, torch.Tensor) else to_torch(a)
    return t.to(device=ref.device, dtype=ref.dtype)


def inject_page(caches, blob, page: int, *, scan: str = "group"):
    """Write ``blob`` into logical ``page`` of every pool, in place; returns
    ``caches`` (the reference returns new caches). Record arrays may be
    host numpy or device tensors (a prefetched page)."""
    groups = kv_pool_groups(caches, scan)
    if len(groups) != len(blob.arrays):
        raise ValueError(f"blob has {len(blob.arrays)} pool records, the "
                         f"cache structure {len(groups)}")
    for (pools, axis), rec in zip(groups, blob.arrays):
        for f, k in _POOL_KEY.items():
            src = _as_tensor(rec[f], pools[0][k])
            if axis == 1:
                for li, p in enumerate(pools):
                    p[k][page] = src[li]
            else:
                pools[0][k][page] = src
    return caches


def cache_geometry(caches, *, scan: str = "group") -> str:
    """Canonical signature of the pool structure as the reference writes
    it (container, record shape minus the page axis, numpy dtype name,
    page axis): a snapshot is injected only into identically shaped
    pools."""
    sig = []
    for pools, axis in kv_pool_groups(caches, scan):
        kp = pools[0]["k_pages"]
        shape = ([len(pools)] if axis == 1 else []) + list(kp.shape)
        del shape[axis]            # page count may differ between servers
        sig.append([pool_container(pools[0]), shape, _NP_NAME[kp.dtype],
                    int(axis)])
    return json.dumps(sig)


# ---------------------------------------------------------------------------
# Host tier
# ---------------------------------------------------------------------------
class HostPageStore:
    """Bounded host-memory page tier: storage and accounting only. Handles
    are opaque ints; what to demote or drop is the callers' policy (the
    prefix cache its demoted nodes, the server its preempted requests).
    ``put`` on a full store raises; callers check :meth:`has_room`."""

    def __init__(self, max_pages: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if max_pages is not None and max_pages < 1:
            raise ValueError("max_pages must be >= 1 (or None = unbounded)")
        self.max_pages = max_pages
        self._blobs: Dict[int, PageBlob] = {}
        self._next = 0
        self.nbytes = 0
        self.puts = 0
        self.pops = 0
        self.drops = 0
        self.peak_pages = 0
        self.peak_bytes = 0
        if metrics is not None:
            metrics.register_gauge("host.bytes", lambda: self.nbytes)
            metrics.register_gauge("host.pages", lambda: self.num_pages)

    @property
    def num_pages(self) -> int:
        return len(self._blobs)

    def has_room(self, n: int = 1) -> bool:
        return (self.max_pages is None
                or self.num_pages + n <= self.max_pages)

    def put(self, blob) -> int:
        if not self.has_room(1):
            raise RuntimeError(
                f"host page tier full ({self.num_pages}/{self.max_pages} "
                f"pages); raise --host-pages or drop cold prefixes first")
        h = self._next
        self._next += 1
        self._blobs[h] = blob
        self.nbytes += blob.nbytes
        self.puts += 1
        self.peak_pages = max(self.peak_pages, self.num_pages)
        self.peak_bytes = max(self.peak_bytes, self.nbytes)
        return h

    def get(self, handle: int) -> PageBlob:
        """The parked blob; reading resolves a pending transfer in place."""
        blob = self._blobs[handle]
        if isinstance(blob, PendingPageBlob):
            blob = self._blobs[handle] = blob.resolve()
        return blob

    def pop(self, handle: int) -> PageBlob:
        blob = self._blobs.pop(handle)
        self.nbytes -= blob.nbytes
        self.pops += 1
        if isinstance(blob, PendingPageBlob):
            blob = blob.resolve()
        return blob

    def drop(self, handle: int) -> None:
        blob = self._blobs.pop(handle)
        self.nbytes -= blob.nbytes
        self.drops += 1

    def bytes_by_container(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for blob in self._blobs.values():
            for cont, b in blob.bytes_by_container().items():
                out[cont] = out.get(cont, 0) + b
        return out


# ---------------------------------------------------------------------------
# Pager: moves pages between the tiers
# ---------------------------------------------------------------------------
_MAX_INFLIGHT = 2    # async device -> host transfers riding behind decode
_MAX_STAGED = 8      # prefetched host -> device uploads awaiting their use


class TieredPager:
    """Demote / offload / promote over (allocator, host store, caches).

    ``get_caches`` returns the server's cache list (the reference also
    takes a setter; the port writes the pools in place, so the list never
    changes). ``scan`` is the record grouping
    (``paged_kv.kv_pool_groups``). ``promote`` may trigger allocator
    pressure (reclaim -> prefix-cache demotion), which is safe: eviction
    never touches pinned or non-resident nodes.

    ``async_mode=True``: a demote or offload issues its copy
    (:func:`extract_page_async` on the pager's side stream, into the next
    of a ring of ``_MAX_INFLIGHT + 1`` pinned buffers), frees the device
    page at once, and up to ``_MAX_INFLIGHT`` transfers ride behind decode
    until :meth:`drain` (the serve loop calls it at span boundaries)
    resolves them into ordinary host memory; reading a pending handle
    resolves it early. :meth:`prefetch` stages a parked page's upload
    ahead of its :meth:`promote` or :meth:`resume`. Completed transfers
    are recorded as retrospective spans on the tracer's pager track."""

    demotions = metric_attr("pager.demotions")
    promotions = metric_attr("pager.promotions")
    prefetches = metric_attr("pager.prefetches")
    prefetch_hits = metric_attr("pager.prefetch_hits")
    staged_resumes = metric_attr("pager.staged_resumes")

    def __init__(self, allocator, host: HostPageStore, get_caches,
                 metrics: Optional[MetricsRegistry] = None,
                 *, async_mode: bool = False, tracer=None,
                 scan: str = "group"):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.allocator = allocator
        self.host = host
        self._get = get_caches
        self.async_mode = bool(async_mode)
        self.tracer = tracer
        self.scan = scan
        self._stream: Optional["torch.cuda.Stream"] = None
        self._inflight = collections.deque()   # (pending, t0, kind)
        # pinned landing buffers of the device -> host copies, reused in
        # turn, and the transfer each one last received
        self._ring: List[List[Dict[str, torch.Tensor]]] = []
        self._ring_user: List[Optional[PendingPageBlob]] = []
        self._issued = 0
        # handle -> (device records, copy event, pinned buffers, issue time)
        self._staged: Dict[int, tuple] = {}
        self.demotions = 0
        self.promotions = 0
        self.prefetches = 0
        self.prefetch_hits = 0
        self.staged_resumes = 0     # the port's own: see resume()
        self._h_demote = self.metrics.histogram("pager.demote_s")
        self._h_promote = self.metrics.histogram("pager.promote_s")
        self._h_offload = self.metrics.histogram("pager.offload_s")
        self._ewma_demote = Ewma()
        self._ewma_promote = Ewma()
        self.metrics.register_gauge("pager.demote_ewma_s",
                                    self._ewma_demote.get)
        self.metrics.register_gauge("pager.promote_ewma_s",
                                    self._ewma_promote.get)
        self.metrics.register_gauge("pager.inflight",
                                    lambda: len(self._inflight))

    def _device(self) -> torch.device:
        return kv_pool_groups(self._get())[0][0][0]["k_pages"].device

    def _side_stream(self) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(self._device())
        return self._stream

    def host_room(self) -> float:
        """Host pages still available (inf when unbounded)."""
        if self.host.max_pages is None:
            return float("inf")
        return max(0, self.host.max_pages - self.host.num_pages)

    def extract(self, page: int) -> PageBlob:
        return extract_page(self._get(), page, scan=self.scan)

    @property
    def pinned_bytes(self) -> int:
        """Pinned host memory the pager holds: the landing ring and the
        staged uploads' buffers. Bounded by ``_MAX_INFLIGHT + 1`` and
        ``_MAX_STAGED`` pages, whatever the host tier's size."""
        ring = sum(int(t.nbytes) for recs in self._ring for rec in recs
                   for t in rec.values())
        return ring + sum(int(t.nbytes) for st in self._staged.values()
                          for t in st[2])

    def _extract_async(self, page: int) -> PendingPageBlob:
        caches = self._get()
        if self._device().type != "cuda":
            return extract_page_async(caches, page, scan=self.scan)
        slot = self._issued % (_MAX_INFLIGHT + 1)
        self._issued += 1
        if slot == len(self._ring):
            self._ring.append(_pinned_records(caches, scan=self.scan))
            self._ring_user.append(None)
        prev = self._ring_user[slot]
        if prev is not None:
            prev.resolve()       # drained already, unless read out of turn
        pending = extract_page_async(caches, page, scan=self.scan,
                                     stream=self._side_stream(),
                                     buffers=self._ring[slot])
        self._ring_user[slot] = pending
        return pending

    def demote(self, page: int) -> int:
        """Copy ``page`` to the host tier, release the caller's device
        reference (it must be the only one), return the host handle. In
        async mode the handle maps to a pending transfer."""
        t0 = time.perf_counter()
        if self.async_mode:
            pending = self._extract_async(page)
            h = self.host.put(pending)
            self.allocator.free([page])
            self.demotions += 1
            self._enqueue(pending, t0, "demote")
            return h
        h = self.host.put(self.extract(page))
        self.allocator.free([page])
        self.demotions += 1
        dt = time.perf_counter() - t0
        self._h_demote.observe(dt)
        self._ewma_demote.update(dt)
        if self.tracer is not None:
            self.tracer.pager_span("pager.demote", t0, t0 + dt)
        return h

    def offload(self, page: int) -> int:
        """Host-park a page the CALLER still owns and frees (a preemption
        victim's page): the same transfer as :meth:`demote`, but allocator
        bookkeeping and demotion counters stay with the caller."""
        if not self.async_mode:
            return self.host.put(self.extract(page))
        t0 = time.perf_counter()
        pending = self._extract_async(page)
        h = self.host.put(pending)
        self._enqueue(pending, t0, "offload")
        return h

    # -- promote-direction prefetch -----------------------------------------
    def stage_room(self) -> int:
        """Prefetch slots still free; prunes staged copies whose host
        handle disappeared (the prefix cache dropped the node)."""
        stale = [h for h in self._staged if h not in self.host._blobs]
        for h in stale:
            del self._staged[h]
        return _MAX_STAGED - len(self._staged)

    def prefetch(self, handle: int) -> int:
        """Start the host -> device copy of a parked page ahead of its
        promote: through a pinned buffer, on the side stream, an event
        recorded after it; :meth:`promote` makes the compute stream wait on
        that event and injects the staged tensors. Pure staging (no
        allocation, no host accounting), so it cannot change tokens.
        Returns 1 when a copy was staged, 0 when skipped (sync mode,
        already staged, stage full, unknown handle, or its own demote copy
        still in flight)."""
        if not self.async_mode or handle in self._staged \
                or self.stage_room() <= 0:
            return 0
        blob = self.host._blobs.get(handle)
        if blob is None:
            return 0
        if isinstance(blob, PendingPageBlob):
            if not blob.resolved:
                return 0   # its device -> host copy still rides a span
            blob = blob.resolve()
        dev = self._device()
        pins, ev = [], None
        if dev.type == "cuda":
            side = self._side_stream()
            with torch.cuda.stream(side):
                recs = []
                for rec in blob.arrays:
                    out = {}
                    for f in _FIELDS:
                        src = to_torch(rec[f])
                        pin = torch.empty(src.shape, dtype=src.dtype,
                                          pin_memory=True)
                        pin.copy_(src)
                        out[f] = pin.to(dev, non_blocking=True)
                        pins.append(pin)
                    recs.append(out)
                ev = torch.cuda.Event()
                ev.record(side)
        else:
            recs = [{f: to_torch(rec[f]).clone() for f in _FIELDS}
                    for rec in blob.arrays]
        self._staged[handle] = (recs, ev, pins, time.perf_counter())
        self.prefetches += 1
        return 1

    def _unpark(self, handle: int) -> Tuple[int, Optional[tuple]]:
        """Allocate a device page (may trigger reclaim pressure), inject the
        parked page into it and release the host copy. A prefetched handle
        injects its staged tensors (uploaded from the same bytes) after the
        compute stream waits on their copy. Returns the page and the staged
        entry used (None: read from the host)."""
        staged = self._staged.pop(handle, None)
        page = self.allocator.alloc()
        blob = self.host.pop(handle)
        if staged is not None:
            recs, ev, _, _ = staged
            if ev is not None:
                cur = torch.cuda.current_stream(self._device())
                cur.wait_event(ev)
                for rec in recs:
                    for t in rec.values():
                        t.record_stream(cur)
            blob = PageBlob(recs)
        inject_page(self._get(), blob, page, scan=self.scan)
        return page, staged

    def promote(self, handle: int) -> int:
        """Bring a demoted prefix page back: returns the page id at
        refcount 1, owned by the caller. A prefetched handle counts a hit
        and records a span from the copy's issue to its use."""
        t0 = time.perf_counter()
        page, staged = self._unpark(handle)
        if staged is not None:
            self.prefetch_hits += 1
        self.promotions += 1
        t1 = time.perf_counter()
        dt = t1 - t0
        self._h_promote.observe(dt)
        self._ewma_promote.update(dt)
        if self.tracer is not None:
            if staged is not None:
                self.tracer.pager_span("pager.promote", staged[3], t1,
                                       args={"async": True,
                                             "prefetch": True})
            else:
                self.tracer.pager_span("pager.promote", t0, t1)
        return page

    def resume(self, handle: int) -> int:
        """Bring a preempted request's offloaded page back into a fresh
        device page owned by the caller, using its staged upload when
        :meth:`prefetch` made one. Like :meth:`offload`, its counters stay
        with the caller (the reference counts no promotion and no hit: it
        injects from the host and leaves the staged upload unused); the
        port counts the staged uploads used in ``staged_resumes``."""
        page, staged = self._unpark(handle)
        if staged is not None:
            self.staged_resumes += 1
        return page

    # -- async double buffer ------------------------------------------------
    def _enqueue(self, pending: PendingPageBlob, t0: float,
                 kind: str) -> None:
        self._inflight.append((pending, t0, kind))
        while len(self._inflight) > _MAX_INFLIGHT:
            self._drain_one()

    def _drain_one(self) -> None:
        pending, t0, kind = self._inflight.popleft()
        pending.resolve()
        t1 = time.perf_counter()
        if kind == "demote":
            self._h_demote.observe(t1 - t0)
            self._ewma_demote.update(t1 - t0)
        else:
            self._h_offload.observe(t1 - t0)
        if self.tracer is not None:
            self.tracer.pager_span(f"pager.{kind}", t0, t1,
                                   args={"async": True})

    def drain(self) -> int:
        """Resolve every in-flight transfer (the serve loop calls this at
        decode-span boundaries). Returns the number drained."""
        n = len(self._inflight)
        while self._inflight:
            self._drain_one()
        return n


# ---------------------------------------------------------------------------
# Online requantization: fp -> int8 -> int4
# ---------------------------------------------------------------------------
_QMAX = {"int8": 127.0, "int4": 7.0}
_NARROWER = {"fp": "int8", "int8": "int4", "int4": "int4"}


def _rec_container(rec) -> str:
    """Storage container of one blob record, from its k dtype."""
    return _container(rec["k"].dtype)


def _rec_head_dim(rec) -> int:
    """Logical head dim of a record (int4 stores head_dim/8 packed words)."""
    hd = int(rec["k"].shape[-1])
    return hd * values_per_word(4) if _rec_container(rec) == "int4" else hd


def _unpack4(q: np.ndarray, head_dim: int) -> np.ndarray:
    return unpack_bits(torch.from_numpy(np.ascontiguousarray(q)), 4,
                       head_dim).numpy()


def narrower_container(container: str, *, head_dim: int,
                       floor_bits: int = 4) -> str:
    """One step down the ladder fp -> int8 -> int4; ``container`` itself at
    the floor. ``floor_bits=8`` stops at int8, and a head dim int4
    lane-packing cannot express (head_dim % 8 != 0) floors at int8."""
    nxt = _NARROWER[container]
    if nxt == "int4" and (floor_bits > 4
                          or head_dim % values_per_word(4) != 0):
        return "int8" if container == "fp" else container
    return nxt


def _bcast_scale(s: np.ndarray) -> np.ndarray:
    """Per-(layer-)page scale broadcast over (page_size, KV, head_dim)."""
    s = np.asarray(s, np.float32)
    return s.reshape(s.shape + (1, 1, 1))


def _dequant_plane(q: np.ndarray, scale: np.ndarray, container: str,
                   head_dim: int) -> np.ndarray:
    if container == "int4":
        q = _unpack4(q, head_dim)
    return _float32(q) * _bcast_scale(scale)


def _quant_plane(vals: np.ndarray, container: str):
    """Freshly calibrated per-(layer-)page max-abs quantization, float32
    numpy with ``np.round`` (half to even), as the reference computes it."""
    qmax = _QMAX[container]
    amax = np.max(np.abs(vals), axis=(-3, -2, -1))
    scale = np.maximum(amax / qmax, _SCALE_EPS).astype(np.float32)
    grid = np.clip(np.round(vals / _bcast_scale(scale)), -qmax, qmax)
    if container == "int4":
        packed, _ = pack_bits(torch.from_numpy(grid.astype(np.int32)), 4)
        return packed.numpy(), scale
    return grid.astype(np.int8), scale


def requantize_blob(blob: PageBlob, *, steps: Optional[int] = 1,
                    floor_bits: int = 4,
                    valid_len: Optional[int] = None
                    ) -> Tuple[PageBlob, int]:
    """Repack every record of one page toward a narrower container:
    ``steps`` rungs down fp -> int8 -> int4 (``None`` = to its floor) with
    a freshly calibrated per-(layer-)page max-abs scale. Any pool reads the
    result through its per-page scales (a float pool legally holds an int8
    grid under a non-unit scale). ``valid_len`` zeroes token slots past a
    partial page's written count before calibration. Returns
    ``(new_blob, records_narrowed)``; records at their floor pass
    through."""
    out: List[Dict[str, np.ndarray]] = []
    narrowed = 0
    for rec in blob.arrays:
        cur = _rec_container(rec)
        hd = _rec_head_dim(rec)
        tgt = cur
        for _ in range(64 if steps is None else steps):
            nxt = narrower_container(tgt, head_dim=hd,
                                     floor_bits=floor_bits)
            if nxt == tgt:
                break
            tgt = nxt
        if tgt == cur:
            out.append(dict(rec))
            continue
        k = _dequant_plane(rec["k"], rec["ks"], cur, hd)
        v = _dequant_plane(rec["v"], rec["vs"], cur, hd)
        if valid_len is not None and valid_len < k.shape[-3]:
            k[..., valid_len:, :, :] = 0.0
            v[..., valid_len:, :, :] = 0.0
        kq, ks = _quant_plane(k, tgt)
        vq, vs = _quant_plane(v, tgt)
        out.append({"k": kq, "v": vq, "ks": ks, "vs": vs})
        narrowed += 1
    return PageBlob(out), narrowed


def requantize_page(caches, page: int, *, steps: Optional[int] = 1,
                    floor_bits: int = 4, valid_len: Optional[int] = None,
                    scan: str = "group") -> Tuple[PageBlob, int]:
    """Extract and requantize one logical page (:func:`requantize_blob`).
    The narrowed blob does not go back into its source page: callers park
    it in a :class:`QuantTierStore` or widen and inject it later."""
    return requantize_blob(extract_page(caches, page, scan=scan),
                           steps=steps, floor_bits=floor_bits,
                           valid_len=valid_len)


def _to_pool_dtype(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """Grid values as a float pool's storage dtype (bf16 as ``V2``; an
    int8 or int4 grid is exact in bf16)."""
    if dtype == torch.bfloat16:
        return to_host(torch.from_numpy(_float32(a)).to(torch.bfloat16))
    return a.astype(_NP_NAME[dtype])


def widen_blob(blob: PageBlob, caches, *, scan: str = "group") -> PageBlob:
    """A (possibly narrowed) blob in each pool's own container, ready for
    :func:`inject_page`. An int4 grid into an int8 pool becomes
    ``grid * 16`` under ``scale / 16`` (exact: |grid| <= 7, a power-of-two
    rescale); into a float pool the grid is stored as floats and its scale
    CARRIED, not folded, so a bf16 pool never rounds grid * scale at rest
    (the fp write path resets a recycled page's scale, and a CoW copy
    folds it). The narrowing's rounding loss is not undone."""
    groups = kv_pool_groups(caches, scan)
    if len(groups) != len(blob.arrays):
        raise ValueError("blob/pool record count mismatch")
    out: List[Dict[str, np.ndarray]] = []
    for rec, (pools, _) in zip(blob.arrays, groups):
        cur = _rec_container(rec)
        tgt = pool_container(pools[0])
        hd = _rec_head_dim(rec)
        if cur == tgt:
            out.append(dict(rec))
        elif tgt == "fp":
            dt = pools[0]["k_pages"].dtype
            k, v = rec["k"], rec["v"]
            if cur == "int4":
                k, v = _unpack4(k, hd), _unpack4(v, hd)
            out.append({
                "k": _to_pool_dtype(k, dt), "v": _to_pool_dtype(v, dt),
                "ks": np.asarray(rec["ks"], np.float32),
                "vs": np.asarray(rec["vs"], np.float32)})
        elif tgt == "int8" and cur == "int4":
            up = 1 << 4   # int8/int4 grid-step ratio (exact rescale)
            out.append({
                "k": (_unpack4(rec["k"], hd).astype(np.int32)
                      * up).astype(np.int8),
                "v": (_unpack4(rec["v"], hd).astype(np.int32)
                      * up).astype(np.int8),
                "ks": np.asarray(rec["ks"], np.float32) / up,
                "vs": np.asarray(rec["vs"], np.float32) / up})
        else:
            raise ValueError(
                f"cannot widen a {cur!r} record into a {tgt!r} pool")
    return PageBlob(out)


class QuantTierStore:
    """Bounded DEVICE-resident requantization tier.

    Under pool pressure the prefix cache narrows a cold page one container
    step (:meth:`requantize`), parks the narrowed records here on the card
    (:meth:`put`) and frees the page: no host round trip. A parked page
    re-enters the pool through :meth:`restore` (widened into a fresh page,
    with the narrowing's rounding loss) or narrows further under byte
    pressure (:meth:`deepen`). Capacity is bounded in BYTES: ``pages``
    fully floored page equivalents, sized by narrowing the scratch page
    (its shapes and dtypes give the bytes; its content does not matter).
    The host time of each requantize, deepen and restore goes to the
    ``tier.requantize_s`` / ``tier.deepen_s`` / ``tier.restore_s``
    histograms (on a card it includes the page's device <-> host
    copies)."""

    def __init__(self, get_caches, *, pages: int,
                 floor_bits: int = 4,
                 metrics: Optional[MetricsRegistry] = None,
                 scan: str = "group"):
        if pages < 1:
            raise ValueError("quant tier needs >= 1 page of capacity")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.register_gauge("tier.bytes", lambda: self.nbytes)
        self.metrics.register_gauge("tier.pages", lambda: self.num_pages)
        self._h_requantize = self.metrics.histogram("tier.requantize_s")
        self._h_deepen = self.metrics.histogram("tier.deepen_s")
        self._h_restore = self.metrics.histogram("tier.restore_s")
        if floor_bits not in (4, 8):
            raise ValueError("floor_bits must be 4 or 8")
        self._get = get_caches
        self.floor_bits = floor_bits
        self.scan = scan
        step_blob, can_narrow = requantize_page(get_caches(), 0, steps=1,
                                                floor_bits=floor_bits,
                                                scan=scan)
        floor_blob, _ = requantize_page(get_caches(), 0, steps=None,
                                        floor_bits=floor_bits, scan=scan)
        if not can_narrow:
            raise ValueError(
                "quant tier has nothing to narrow: every pool is already "
                "at its floor container")
        self.page_bytes_step = step_blob.nbytes
        self.page_bytes_floor = floor_blob.nbytes
        self.max_bytes = pages * self.page_bytes_floor
        self._recs: Dict[int, List[Dict[str, torch.Tensor]]] = {}
        self._nb: Dict[int, int] = {}
        self._next = 0
        self.nbytes = 0
        self.puts = 0
        self.pops = 0
        self.drops = 0
        self.deepens = 0
        self.peak_pages = 0
        self.peak_bytes = 0

    @property
    def num_pages(self) -> int:
        return len(self._recs)

    def _device(self) -> torch.device:
        return kv_pool_groups(self._get())[0][0][0]["k_pages"].device

    def room_pages(self) -> int:
        """One-step-narrowed pages that still fit before any deepening
        (the conservative figure admission preflight reports)."""
        return max(0, (self.max_bytes - self.nbytes)
                   // max(self.page_bytes_step, 1))

    def has_room(self, blob: PageBlob) -> bool:
        return self.nbytes + blob.nbytes <= self.max_bytes

    def requantize(self, page: int,
                   valid_len: Optional[int] = None) -> Optional[PageBlob]:
        """One-step-narrower blob of device ``page`` (None: every record is
        already at its floor)."""
        t0 = time.perf_counter()
        blob, n = requantize_page(self._get(), page, steps=1,
                                  floor_bits=self.floor_bits,
                                  valid_len=valid_len, scan=self.scan)
        self._h_requantize.observe(time.perf_counter() - t0)
        return blob if n else None

    def _park(self, blob: PageBlob) -> List[Dict[str, torch.Tensor]]:
        dev = self._device()
        return [{f: to_torch(rec[f]).to(dev) for f in _FIELDS}
                for rec in blob.arrays]

    def put(self, blob: PageBlob) -> int:
        if not self.has_room(blob):
            raise RuntimeError("quant tier byte budget exhausted; deepen "
                               "parked pages or demote to host instead")
        h = self._next
        self._next += 1
        self._recs[h] = self._park(blob)     # the narrowed bytes on the card
        self._nb[h] = blob.nbytes
        self.nbytes += blob.nbytes
        self.puts += 1
        self.peak_pages = max(self.peak_pages, self.num_pages)
        self.peak_bytes = max(self.peak_bytes, self.nbytes)
        return h

    def _host_blob(self, handle: int) -> PageBlob:
        return PageBlob([{f: to_host(t) for f, t in rec.items()}
                         for rec in self._recs[handle]])

    def deepen(self, handle: int,
               valid_len: Optional[int] = None) -> int:
        """Narrow a parked page one more step in place; returns the bytes
        freed (0 = already at the floor). A page whose records are all at
        their floor returns 0 before any copy: the prefix cache tries
        every parked page each time the tier lacks room, so most calls
        of a full tier land here."""
        t0 = time.perf_counter()
        try:
            if all(narrower_container(_rec_container(rec),
                                      head_dim=_rec_head_dim(rec),
                                      floor_bits=self.floor_bits)
                   == _rec_container(rec) for rec in self._recs[handle]):
                return 0
            before = self._nb[handle]
            blob, n = requantize_blob(self._host_blob(handle), steps=1,
                                      floor_bits=self.floor_bits,
                                      valid_len=valid_len)
            if n == 0 or blob.nbytes >= before:
                return 0
            self._recs[handle] = self._park(blob)
            self._nb[handle] = blob.nbytes
            self.nbytes -= before - blob.nbytes
            self.deepens += 1
            return before - blob.nbytes
        finally:
            self._h_deepen.observe(time.perf_counter() - t0)

    def restore(self, handle: int, page: int) -> None:
        """Widen the parked blob into the pools' containers, inject it into
        ``page`` (the caller allocated it), release the slot."""
        t0 = time.perf_counter()
        blob = widen_blob(self._host_blob(handle), self._get(),
                          scan=self.scan)
        inject_page(self._get(), blob, page, scan=self.scan)
        self._h_restore.observe(time.perf_counter() - t0)
        self._release(handle)
        self.pops += 1

    def export(self, handle: int) -> PageBlob:
        """Pool-native copy of a parked page (the snapshot path); the slot
        stays parked."""
        return widen_blob(self._host_blob(handle), self._get(),
                          scan=self.scan)

    def drop(self, handle: int) -> None:
        self._release(handle)
        self.drops += 1

    def _release(self, handle: int) -> None:
        del self._recs[handle]
        self.nbytes -= self._nb.pop(handle)

    def bytes_by_container(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for recs in self._recs.values():
            for cont, b in _records_bytes_by_container(recs).items():
                out[cont] = out.get(cont, 0) + b
        return out


# ---------------------------------------------------------------------------
# Snapshot / restore (persistent prefix pages)
# ---------------------------------------------------------------------------
SNAPSHOT_VERSION = 1


def snapshot_path(path: str) -> str:
    """The on-disk filename for ``path``: ``np.savez`` appends ``.npz`` to
    bare names, so save, load and exists checks all go through here."""
    return path if path.endswith(".npz") else path + ".npz"


def save_prefix_snapshot(path: str, entries, *, page_size: int,
                         geometry: str) -> int:
    """Write prefix-cache chains to ``path`` (one ``np.savez`` archive, the
    reference's format). ``entries`` yields ``(profile_key, tokens,
    PageBlob)`` parents first; ``tokens`` is the full token path through
    the node's own chunk. Returns the pages written."""
    chains = []
    arrays = {}
    n = 0
    for pk, tokens, blob in entries:
        chains.append({"profile": pk, "tokens": [int(t) for t in tokens],
                       "pools": len(blob.arrays)})
        for j, rec in enumerate(blob.arrays):
            for f in _FIELDS:
                arrays[f"e{n}_p{j}_{f}"] = rec[f]
        n += 1
    header = {"version": SNAPSHOT_VERSION, "page_size": int(page_size),
              "geometry": geometry, "chains": chains}
    np.savez(snapshot_path(path), __header__=np.asarray(json.dumps(header)),
             **arrays)
    return n


def load_prefix_snapshot(path: str) -> Tuple[dict, List[tuple]]:
    """Read a snapshot back: ``(meta, [(profile_key, tokens, PageBlob)])``
    in the order saved (parents before children)."""
    with np.load(snapshot_path(path), allow_pickle=False) as z:
        header = json.loads(str(z["__header__"]))
        if header.get("version") != SNAPSHOT_VERSION:
            raise ValueError(f"unsupported snapshot version "
                             f"{header.get('version')!r}")
        entries = []
        for i, ch in enumerate(header["chains"]):
            arrays = [{f: z[f"e{i}_p{j}_{f}"] for f in _FIELDS}
                      for j in range(ch["pools"])]
            entries.append((ch["profile"], list(ch["tokens"]),
                            PageBlob(arrays)))
    meta = {"version": header["version"], "page_size": header["page_size"],
            "geometry": header["geometry"]}
    return meta, entries
