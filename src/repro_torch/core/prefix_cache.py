"""Shared-prefix page cache: a page-granular radix trie over prompt tokens.

Requests that share a system prompt need not prefill and store it again.
Each trie node is one pool page whose KV holds the node's tokens at the
node's absolute positions (RoPE is applied before the cache write, so a
chain matches prompts token for token from position 0 only). A request
whose prompt starts with a cached chain

* aliases every fully matched page: page-table indirection only, kept
  alive by the refcounts of :class:`repro_torch.core.paged_kv.PageAllocator`;
* copies the page it diverges inside (copy-on-write,
  :func:`repro_torch.core.paged_kv.copy_pool_pages`) and extends the copy,
  while the cached source stays byte-identical for its other readers.

Invariants: only full pages are aliased, so a sharer's first write lies
past every aliased page; a partial node is a leaf; tries are namespaced by
a profile key (``quant.apply.kv_profile_key``), so an int8 chain never
backs an int4 request. The cache holds one allocator reference per cached
page; a page is evictable when that is its only reference, its node is
not pinned by an admission in flight, and its whole subtree is evictable.
Eviction (registered as the allocator's ``reclaim`` hook) drops the least
recently used such leaf. Every node here is resident on the card: the
reference's host tier and quant tier (demotion, requantization,
promotion, snapshots) are ROADMAP queue A item 9, and so its ``evict``
reduces to the leaf drop ported here.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..runtime.telemetry import MetricsRegistry, NullTracer, metric_attr
from .paged_kv import PageAllocator

__all__ = ["PrefixCache", "PrefixHit"]

# clock ticks of recency one recorded hit is worth in the heat score (the
# reference's ``heat_boost`` default; settable there for its tiers, which
# are ROADMAP queue A item 9)
_HEAT_BOOST = 16


@dataclasses.dataclass
class PrefixHit:
    """Result of a longest-prefix lookup.

    ``matched == len(nodes) * page_size + cow_valid``. ``nodes`` is the
    fully matched chain (each node one full page); ``cow_node`` (if any)
    is the cached page the query diverges inside, whose first
    ``cow_valid`` tokens the caller copies and treats as written."""

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
    """One cached page: ``tokens`` (<= page_size) stored at ``page``.

    Children are keyed by their token tuple, so a full chunk descends in
    O(1); partial children are leaves, found by the best-common-prefix
    scan. ``pins`` counts admissions in flight that hold this node
    (eviction skips pinned nodes); ``hits`` counts recorded lookup matches
    (the heat score's input)."""

    __slots__ = ("tokens", "page", "children", "parent", "stamp", "pins",
                 "hits")

    def __init__(self, tokens: Tuple[int, ...], page: int, parent,
                 stamp: int):
        self.tokens = tokens
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.stamp = stamp
        self.pins = 0
        self.hits = 0

    @property
    def count(self) -> int:
        return len(self.tokens)


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class PrefixCache:
    """Radix index of cached prompt pages over one server's page pool.

    Counters live in ``metrics`` under "prefix.*" (``metric_attr``);
    ``stats()`` reads them with the reference's keys, whose host-tier and
    quant-tier entries stay 0 here."""

    lookups = metric_attr("prefix.lookups")
    hits = metric_attr("prefix.hits")
    hit_tokens = metric_attr("prefix.hit_tokens")
    lookup_tokens = metric_attr("prefix.lookup_tokens")
    inserted_pages = metric_attr("prefix.inserted_pages")
    cow_copies = metric_attr("prefix.cow_copies")
    evictions = metric_attr("prefix.evictions")

    def __init__(self, allocator: PageAllocator, page_size: int,
                 profile_key: str = "", pager=None, tier=None,
                 metrics: Optional[MetricsRegistry] = None, tracer=None):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if pager is not None or tier is not None:
            raise NotImplementedError(
                "the prefix cache's host tier and quant tier are not ported "
                "yet: ROADMAP queue A item 9")
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NullTracer()
        self.allocator = allocator
        self.page_size = page_size
        self.profile_key = profile_key
        self._roots: Dict[str, _Node] = {}
        self._clock = itertools.count()
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.inserted_pages = 0
        self.cow_copies = 0          # bumped by the server after each copy
        self.evictions = 0

    # -- internals ----------------------------------------------------------
    def _root(self, profile_key: Optional[str]) -> _Node:
        key = self.profile_key if profile_key is None else profile_key
        if key not in self._roots:
            self._roots[key] = _Node((), -1, None, next(self._clock))
        return self._roots[key]

    def _nodes(self) -> List[_Node]:
        out = []
        stack = list(self._roots.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.parent is not None:
                out.append(n)
        return out

    @staticmethod
    def _detach(node: _Node) -> None:
        del node.parent.children[node.tokens]
        node.parent = None

    def _heat(self, n: _Node) -> int:
        """Victim score of the reference's tiered eviction: the LRU stamp
        plus ``_HEAT_BOOST`` ticks per recorded hit (lowest is coldest).
        Without a tier, eviction is the leaf drop, which is pure LRU."""
        return n.stamp + _HEAT_BOOST * n.hits

    # -- stats --------------------------------------------------------------
    @property
    def num_pages(self) -> int:
        """Device pages currently retained by the cache."""
        return len(self._nodes())

    def evictable_pages(self) -> int:
        """Pages leaf-first eviction could free now: refcount-1 unpinned
        nodes whose whole subtree is evictable too (an ancestor of a
        referenced page must stay, or a reader's chain gets a hole)."""

        def count(node: _Node) -> Tuple[int, bool]:
            n, free = 0, True
            for c in node.children.values():
                cn, cfree = count(c)
                n += cn
                free &= cfree
            if node.pins:
                return n, False
            if node.parent is None:           # a root holds no page
                return n, free
            if free and self.allocator.refcount(node.page) == 1:
                return n + 1, True
            return n, False
        return sum(count(r)[0] for r in self._roots.values())

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

    # -- pinning ------------------------------------------------------------
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
    def _drop_one(self) -> bool:
        """Free the least recently used unpinned refcount-1 leaf page."""
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

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` cached pages, least recently used leaves
        first; returns the pages freed. (The reference requantizes or
        demotes first when a quant tier or host tier is attached: ROADMAP
        queue A item 9.)"""
        freed = 0
        while freed < n_pages and self._drop_one():
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every unpinned, unreferenced page, leaves first and
        cascading. Returns the pages the cache still retains (some slot
        also references them: nonzero once every slot is released means a
        refcount leak)."""
        changed = True
        while changed:
            changed = False
            for node in self._nodes():
                if node.children or node.pins:
                    continue
                if self.allocator.refcount(node.page) != 1:
                    continue
                self._detach(node)
                self.allocator.free([node.page])
                self.evictions += 1
                changed = True
        return self.num_pages

    def stats(self) -> dict:
        """The reference's ``stats()`` keys; the host-tier and quant-tier
        ones (item 9) are 0, or None for ``requants_at_first_demotion``."""
        return {
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_rate": self.hits / max(self.lookups, 1),
            "hit_tokens": self.hit_tokens,
            "token_hit_rate": self.hit_tokens / max(self.lookup_tokens, 1),
            "cached_pages": self.num_pages,
            "host_pages": 0,
            "evictable_pages": self.evictable_pages(),
            "inserted_pages": self.inserted_pages,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "demotions": 0, "promotions": 0, "host_drops": 0,
            "restored_pages": 0, "requants": 0, "deepens": 0,
            "tier_pages": 0, "tier_promotions": 0,
            "requantizable_pages": 0,
            "requants_at_first_demotion": None,
        }
