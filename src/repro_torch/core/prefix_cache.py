"""Shared-prefix page cache: a page-granular radix trie over prompt tokens.

Requests that share a system prompt need not prefill and store it again.
Each trie node is one page whose KV holds the node's tokens at the node's
absolute positions (RoPE is applied before the cache write, so a chain
matches prompts token for token from position 0 only). A request whose
prompt starts with a cached chain

* aliases every fully matched page: page-table indirection only, kept
  alive by the refcounts of :class:`repro_torch.core.paged_kv.PageAllocator`;
* copies the page it diverges inside (copy-on-write,
  :func:`repro_torch.core.paged_kv.copy_pool_pages`) and extends the copy,
  while the cached source stays byte-identical for its other readers.

A node is in one of three states: **resident** (``node.page`` is a device
page; the cache holds one reference), **tier** (``node.tier``: the page was
requantized one container step narrower into the device-resident
``core.page_store.QuantTierStore`` and its page freed; a hit restores it
into a fresh page with the narrowing's rounding loss), or **host**
(``node.host``: the page's bytes were demoted to the host tier; a hit
promotes it back before aliasing; a restored snapshot creates nodes in
this state).

Invariants: only full pages are aliased, so a sharer's first write lies
past every aliased page; a partial node is a leaf; tries are namespaced by
a profile key (``quant.apply.kv_profile_key``), so an int8 chain never
backs an int4 request; a chain may mix resident, tier and host nodes
(demoting a mid-chain node leaves no hole), but destroying a node stays
leaf-only. Eviction (the allocator's ``reclaim`` hook) runs requantize ->
demote -> drop: the coldest page by heat score onto the quant tier when
one is attached, then to the host tier when a pager with room is
attached, and the least recently used droppable leaf last. Admission pins
a hit's nodes so its own allocations cannot evict the chain.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..runtime.telemetry import MetricsRegistry, NullTracer, metric_attr
from .paged_kv import PageAllocator

__all__ = ["PrefixCache", "PrefixHit"]

# victim picking for requantize / demote / deepen: each recorded hit is
# worth this many clock ticks of recency (the reference's heat_boost)
_HEAT_BOOST = 16

@dataclasses.dataclass
class PrefixHit:
    """Result of a longest-prefix lookup.

    ``matched == len(nodes) * page_size + cow_valid``. ``nodes`` is the
    fully matched chain (each node one full page, in any state);
    ``cow_node`` (if any) is the cached page the query diverges inside,
    whose first ``cow_valid`` tokens the caller copies (after making it
    resident) and treats as written. ``full_pages`` / ``cow_page`` give
    the device page ids (-1 for a node off the device)."""

    matched: int = 0
    nodes: List["_Node"] = dataclasses.field(default_factory=list)
    cow_node: Optional["_Node"] = None
    cow_valid: int = 0

    @property
    def full_pages(self) -> List[int]:
        return [n.page for n in self.nodes]

    @property
    def cow_page(self) -> Optional[int]:
        return None if self.cow_node is None else self.cow_node.page


class _Node:
    """One cached page: ``tokens`` (<= page_size) stored at device ``page``
    (resident), behind quant-tier handle ``tier``, or behind host-tier
    handle ``host``.

    Children are keyed by their token tuple, so a full chunk descends in
    O(1); partial children are leaves, found by the best-common-prefix
    scan. ``pins`` counts admissions in flight that hold this node
    (eviction skips pinned nodes); ``hits`` counts recorded lookup matches
    (the heat score's input)."""

    __slots__ = ("tokens", "page", "host", "tier", "children", "parent",
                 "stamp", "pins", "hits")

    def __init__(self, tokens: Tuple[int, ...], page: int, parent,
                 stamp: int, host: Optional[int] = None):
        self.tokens = tokens
        self.page = page
        self.host = host
        self.tier: Optional[int] = None
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = stamp
        self.pins = 0
        self.hits = 0

    @property
    def count(self) -> int:
        return len(self.tokens)

    @property
    def resident(self) -> bool:
        return self.page >= 0


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixCache:
    """Radix index of cached prompt pages over one server's page pool.

    The cache holds ONE allocator reference per resident cached page, on
    top of whatever slots reference it, so a resident page is evictable
    exactly when its refcount is 1. ``pager`` (a
    ``core.page_store.TieredPager``) enables the host tier and ``tier`` (a
    ``core.page_store.QuantTierStore``) the requantization tier; without
    them eviction is the destructive leaf drop. Counters live in
    ``metrics`` under "prefix.*" (``metric_attr``); ``stats()`` reads them
    with the reference's keys."""

    lookups = metric_attr("prefix.lookups")
    hits = metric_attr("prefix.hits")
    hit_tokens = metric_attr("prefix.hit_tokens")
    lookup_tokens = metric_attr("prefix.lookup_tokens")
    inserted_pages = metric_attr("prefix.inserted_pages")
    cow_copies = metric_attr("prefix.cow_copies")
    evictions = metric_attr("prefix.evictions")
    demotions = metric_attr("prefix.demotions")
    promotions = metric_attr("prefix.promotions")
    host_drops = metric_attr("prefix.host_drops")
    restored_pages = metric_attr("prefix.restored_pages")
    requants = metric_attr("prefix.requants")
    deepens = metric_attr("prefix.deepens")
    tier_promotions = metric_attr("prefix.tier_promotions")

    def __init__(self, allocator: PageAllocator, page_size: int,
                 profile_key: str = "", pager=None, tier=None,
                 metrics: Optional[MetricsRegistry] = None, tracer=None):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NullTracer()
        self.allocator = allocator
        self.page_size = page_size
        self.profile_key = profile_key
        self.pager = pager
        self.tier = tier
        self._roots: Dict[str, _Node] = {}
        self._clock = itertools.count()
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserted_pages = 0
        self.cow_copies = 0          # bumped by the server after each copy
        self.evictions = 0           # destructive drops of resident pages
        self.demotions = 0           # resident -> host
        self.promotions = 0          # host -> resident
        self.host_drops = 0          # destructive drops of host pages
        self.restored_pages = 0      # nodes created from a snapshot
        self.requants = 0            # resident -> quant tier
        self.deepens = 0             # tier pages narrowed a further step
        self.tier_promotions = 0     # quant tier -> resident
        # requantizations before the first host demotion (None until one)
        self.requants_at_first_demotion: Optional[int] = None

    # -- internals ----------------------------------------------------------
    def _root(self, profile_key: Optional[str]) -> _Node:
        key = self.profile_key if profile_key is None else profile_key
        if key not in self._roots:
            self._roots[key] = _Node((), -1, None, next(self._clock))
        return self._roots[key]

    def _all_nodes(self) -> List[_Node]:
        out = []
        stack = list(self._roots.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.parent is not None:
                out.append(n)
        return out

    def _nodes(self) -> List[_Node]:
        return [n for n in self._all_nodes() if n.resident]

    @staticmethod
    def _detach(node: _Node) -> None:
        del node.parent.children[node.tokens]
        node.parent = None

    def _heat(self, n: _Node) -> int:
        """Victim score for requantize / demote / deepen: the LRU stamp plus
        ``_HEAT_BOOST`` ticks per recorded hit (lowest is coldest)."""
        return n.stamp + _HEAT_BOOST * n.hits

    # -- stats --------------------------------------------------------------
    @property
    def num_pages(self) -> int:
        """Device pages currently retained by the cache (resident nodes)."""
        return len(self._nodes())

    @property
    def host_pages(self) -> int:
        """Cached pages currently demoted to the host tier."""
        return sum(1 for n in self._all_nodes() if n.host is not None)

    @property
    def tier_pages(self) -> int:
        """Cached pages currently parked in the quant tier."""
        return sum(1 for n in self._all_nodes() if n.tier is not None)

    def _droppable_pages(self) -> int:
        """Resident pages destructive leaf-first eviction could free:
        refcount-1 unpinned nodes whose whole subtree is reclaimable too
        (an ancestor of a referenced page must stay, or a reader's chain
        gets a hole)."""

        def count(node: _Node) -> Tuple[int, bool]:
            n, free = 0, True
            for c in node.children.values():
                cn, cfree = count(c)
                n += cn
                free &= cfree
            if node.pins:
                return n, False
            if node.resident:
                if free and self.allocator.refcount(node.page) == 1:
                    return n + 1, True
                return n, False
            return n, free
        return sum(count(r)[0] for r in self._roots.values())

    def _demotable_nodes(self) -> List[_Node]:
        """Resident refcount-1 unpinned nodes, at any trie position: the
        requantization and demotion candidates."""
        return [n for n in self._nodes()
                if not n.pins and self.allocator.refcount(n.page) == 1]

    def evictable_pages(self) -> int:
        """Device pages reclaimable now: by requantization onto the quant
        tier (byte room permitting), demotion (host room permitting) and
        destructive leaf-first drops."""
        drop = self._droppable_pages()
        demotable = len(self._demotable_nodes())
        room = self.tier.room_pages() if self.tier is not None else 0
        if self.pager is not None:
            host_room = self.pager.host_room()
            if host_room == float("inf"):
                return demotable
            room += int(host_room)
        # every droppable node is demotable too, so with no tier and no
        # pager this is the droppable count
        return min(demotable, drop + room)

    def requantizable_pages(self) -> int:
        """Cold resident pages the quant tier could narrow and park now
        (``OutOfPagesError.requantizable``)."""
        if self.tier is None:
            return 0
        return min(len(self._demotable_nodes()), self.tier.room_pages())

    # -- lookup -------------------------------------------------------------
    def lookup(self, tokens: Sequence[int],
               profile_key: Optional[str] = None,
               record: bool = True) -> PrefixHit:
        """Longest cached prefix of ``tokens`` (full pages, then the best
        intra-page match). No refcount changes; the caller pins the hit
        before anything that could evict. ``record=False`` leaves the
        hit-rate counters and per-node hits alone (admission retries a
        deferred request every span and records once, with
        :meth:`note_lookup`); LRU stamps refresh either way."""
        tokens = [int(t) for t in tokens]
        if record:
            self.lookups += 1
            self.lookup_tokens += len(tokens)
        hit = PrefixHit()
        node = self._root(profile_key)
        ps = self.page_size
        i = 0
        while i < len(tokens):
            chunk = tuple(tokens[i:i + ps])
            child = node.children.get(chunk) if len(chunk) == ps else None
            if child is not None and child.count == ps:
                child.stamp = next(self._clock)
                if record:
                    child.hits += 1
                hit.nodes.append(child)
                hit.matched += ps
                node = child
                i += ps
                continue
            best, best_len = None, 0
            for c in node.children.values():
                n = _common_prefix(c.tokens, chunk)
                if n > best_len:
                    best, best_len = c, n
            if best is not None:
                best.stamp = next(self._clock)
                if record:
                    best.hits += 1
                hit.cow_node = best
                hit.cow_valid = best_len
                hit.matched += best_len
            break
        if record and hit.matched:
            self.hits += 1
            self.hit_tokens += hit.matched
        return hit

    def peek_chain(self, tokens: Sequence[int],
                   profile_key: Optional[str] = None) -> List[_Node]:
        """The cached chain matching ``tokens``, full nodes then the
        diverging node if any: a pure read (no stamps, no hit counts, no
        clock ticks, no root created)."""
        tokens = [int(t) for t in tokens]
        key = self.profile_key if profile_key is None else profile_key
        node = self._roots.get(key)
        out: List[_Node] = []
        if node is None:
            return out
        ps = self.page_size
        i = 0
        while i + ps <= len(tokens):
            child = node.children.get(tuple(tokens[i:i + ps]))
            if child is None or child.count != ps:
                break
            out.append(child)
            node = child
            i += ps
        chunk = tuple(tokens[i:i + ps])
        best, best_len = None, 0
        for c in node.children.values():
            n = _common_prefix(c.tokens, chunk)
            if n > best_len:
                best, best_len = c, n
        if best is not None:
            out.append(best)
        return out

    def note_lookup(self, n_tokens: int, matched: int) -> None:
        """Record one admission's hit-rate sample (pairs with
        ``lookup(record=False)``)."""
        self.lookups += 1
        self.lookup_tokens += n_tokens
        if matched:
            self.hits += 1
            self.hit_tokens += matched

    # -- pinning / promotion ------------------------------------------------
    @staticmethod
    def _hit_nodes(hit: PrefixHit) -> List[_Node]:
        return hit.nodes + ([hit.cow_node] if hit.cow_node is not None
                            else [])

    def pin(self, hit: PrefixHit) -> None:
        """Shield a hit's chain from eviction while an admission is in
        flight. Balanced by :meth:`unpin`."""
        for n in self._hit_nodes(hit):
            n.pins += 1

    def unpin(self, hit: PrefixHit) -> None:
        for n in self._hit_nodes(hit):
            assert n.pins > 0, "unbalanced prefix-cache unpin"
            n.pins -= 1

    def pin_node(self, node: _Node) -> None:
        node.pins += 1

    def unpin_node(self, node: _Node) -> None:
        assert node.pins > 0, "unbalanced prefix-cache node unpin"
        node.pins -= 1

    def host_nodes_in(self, hit: PrefixHit) -> int:
        """Nodes of a hit off the device (host or quant tier): an admission
        spends one device page on each to make it resident."""
        return sum(1 for n in self._hit_nodes(hit) if not n.resident)

    def ensure_resident(self, node: _Node) -> int:
        """Make ``node`` resident (restore it from the quant tier or promote
        it from the host tier) and return its device page, whose single
        reference is the cache's. Allocating may trigger reclaim, which is
        safe: the caller pinned the chain."""
        if node.resident:
            return node.page
        if node.tier is not None:
            page = self.allocator.alloc()
            self.tier.restore(node.tier, page)
            node.tier = None
            node.page = page
            self.tier_promotions += 1
            self.tracer.instant("prefix.tier_promote", args={"page": page})
            return page
        if self.pager is None:
            raise RuntimeError("host-state node without a pager")
        node.page = self.pager.promote(node.host)
        node.host = None
        self.promotions += 1
        self.tracer.instant("prefix.promote", args={"page": node.page})
        return node.page

    # -- insert -------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               profile_key: Optional[str] = None) -> int:
        """Index ``tokens``, page-chunked into ``pages`` (``pages[j]`` holds
        the KV of ``tokens[j*ps:(j+1)*ps]`` at those positions). Chunks
        already cached dedupe: the existing node is reused and the caller's
        duplicate page stays its own. Each newly indexed page gets one
        cache reference (``allocator.incref``). Returns the pages newly
        retained."""
        tokens = [int(t) for t in tokens]
        ps = self.page_size
        need = -(-len(tokens) // ps) if tokens else 0
        if len(pages) < need:
            raise ValueError(f"insert needs {need} pages for "
                             f"{len(tokens)} tokens, got {len(pages)}")
        node = self._root(profile_key)
        added = 0
        for j in range(need):
            chunk = tuple(tokens[j * ps:(j + 1) * ps])
            full = len(chunk) == ps
            if full:
                child = node.children.get(chunk)
                if child is not None:
                    child.stamp = next(self._clock)
                    node = child
                    continue
            elif any(_common_prefix(c.tokens, chunk) == len(chunk)
                     for c in node.children.values()):
                break       # the partial tail is already covered
            page = int(pages[j])
            self.allocator.incref(page)
            child = _Node(chunk, page, node, next(self._clock))
            node.children[chunk] = child
            added += 1
            if not full:
                break
            node = child
        self.inserted_pages += added
        return added

    def insert_host(self, tokens: Sequence[int], handle: int,
                    profile_key: Optional[str] = None) -> bool:
        """Create ONE node directly in the host state (snapshot restore).
        ``tokens`` is the full path through the node's own chunk; every
        ancestor chunk must exist already (restore feeds parents first).
        Returns False, without consuming the handle, when the node exists
        or an ancestor is missing."""
        tokens = [int(t) for t in tokens]
        ps = self.page_size
        if not tokens:
            return False
        node = self._root(profile_key)
        n_chunks = -(-len(tokens) // ps)
        for j in range(n_chunks - 1):
            node = node.children.get(tuple(tokens[j * ps:(j + 1) * ps]))
            if node is None or node.count != ps:
                return False
        chunk = tuple(tokens[(n_chunks - 1) * ps:])
        if chunk in node.children:
            return False
        node.children[chunk] = _Node(chunk, -1, node, next(self._clock),
                                     host=handle)
        self.restored_pages += 1
        return True

    def iter_chain_nodes(self) -> Iterator[Tuple[str, List[int], _Node]]:
        """Yield ``(profile_key, full_tokens, node)`` for every cached page,
        parents before children."""
        for key, root in self._roots.items():
            stack = [(root, [])]
            while stack:
                node, prefix = stack.pop()
                if node.parent is not None:
                    prefix = prefix + list(node.tokens)
                    yield key, prefix, node
                for c in node.children.values():
                    stack.append((c, prefix))

    # -- eviction -----------------------------------------------------------
    def drop_host_lru(self) -> bool:
        """Destroy the least recently used unpinned host-tier LEAF (frees
        host room, no device effect). False when there is none."""
        victim = None
        for n in self._all_nodes():
            if n.resident or n.host is None or n.pins or n.children:
                continue
            if victim is None or n.stamp < victim.stamp:
                victim = n
        if victim is None:
            return False
        self.pager.host.drop(victim.host)
        self._detach(victim)
        self.host_drops += 1
        self.tracer.instant("prefix.host_drop")
        return True

    def _drop_one(self) -> bool:
        """Free the least recently used droppable resident leaf page."""
        victim = None
        for node in self._nodes():
            if node.children or node.pins:
                continue
            if self.allocator.refcount(node.page) != 1:
                continue
            if victim is None or node.stamp < victim.stamp:
                victim = node
        if victim is None:
            return False
        self._detach(victim)
        self.allocator.free([victim.page])
        self.evictions += 1
        self.tracer.instant("prefix.drop")
        return True

    def _demote_one(self) -> bool:
        """Move the coldest demotable resident page to the host tier,
        dropping host leaves first when the tier is full."""
        if self.pager is None:
            return False
        cands = self._demotable_nodes()
        if not cands:
            return False
        while not self.pager.host.has_room(1):
            if not self.drop_host_lru():
                return False
        victim = min(cands, key=self._heat)
        victim.host = self.pager.demote(victim.page)
        victim.page = -1
        self.demotions += 1
        self.tracer.instant("prefix.demote")
        if self.demotions == 1:
            self.requants_at_first_demotion = self.requants
        return True

    def _requant_one(self) -> bool:
        """Narrow the coldest demotable page one container step into the
        quant tier and free its device page, deepening parked pages first
        when the tier lacks the bytes. False when no tier is attached,
        nothing can narrow, or no room can be made."""
        if self.tier is None:
            return False
        cands = self._demotable_nodes()
        if not cands:
            return False
        victim = min(cands, key=self._heat)
        blob = self.tier.requantize(victim.page, valid_len=victim.count)
        if blob is None:
            return False
        while not self.tier.has_room(blob):
            if not self._deepen_one():
                return False
        handle = self.tier.put(blob)
        self.allocator.free([victim.page])
        victim.page = -1
        victim.tier = handle
        self.requants += 1
        self.tracer.instant("prefix.requant")
        return True

    def _deepen_one(self) -> bool:
        """Narrow the coldest unpinned parked page one more step. False
        when none can narrow further."""
        parked = sorted((n for n in self._all_nodes()
                         if n.tier is not None and not n.pins),
                        key=self._heat)
        for n in parked:
            if self.tier.deepen(n.tier, valid_len=n.count):
                self.deepens += 1
                self.tracer.instant("prefix.deepen")
                return True
        return False

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` device pages held by the cache, in
        requantize -> demote -> drop order (lossy by one container step, no
        host traffic; byte-exact to the host tier; destroyed). Returns the
        pages freed."""
        freed = 0
        while freed < n_pages:
            if self._requant_one() or self._demote_one() \
                    or self._drop_one():
                freed += 1
                continue
            break
        return freed

    def clear(self) -> int:
        """Drop every unpinned, unreferenced page (resident, quant-tier and
        host), leaves first and cascading. Returns the device pages the
        cache still retains (some slot also references them: nonzero once
        every slot is released means a refcount leak)."""
        changed = True
        while changed:
            changed = False
            for node in self._all_nodes():
                if node.children or node.pins:
                    continue
                if node.resident:
                    if self.allocator.refcount(node.page) != 1:
                        continue
                    self._detach(node)
                    self.allocator.free([node.page])
                    self.evictions += 1
                elif node.tier is not None:
                    self.tier.drop(node.tier)
                    self._detach(node)
                else:
                    self.pager.host.drop(node.host)
                    self._detach(node)
                    self.host_drops += 1
                changed = True
        return self.num_pages

    def stats(self) -> dict:
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / max(self.lookups, 1),
            "hit_tokens": self.hit_tokens,
            "token_hit_rate": self.hit_tokens / max(self.lookup_tokens, 1),
            "cached_pages": self.num_pages,
            "host_pages": self.host_pages,
            "evictable_pages": self.evictable_pages(),
            "inserted_pages": self.inserted_pages,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "demotions": self.demotions,
            "promotions": self.promotions,
            "host_drops": self.host_drops,
            "restored_pages": self.restored_pages,
            "requants": self.requants,
            "deepens": self.deepens,
            "tier_pages": self.tier_pages,
            "tier_promotions": self.tier_promotions,
            "requantizable_pages": self.requantizable_pages(),
            "requants_at_first_demotion": self.requants_at_first_demotion,
        }
