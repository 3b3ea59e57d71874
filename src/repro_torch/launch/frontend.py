"""Multi-replica admission front: prefix-affinity routing over a pool of
:class:`~repro_torch.launch.serve.BatchedServer` replicas on ONE shared
decode-step clock.

One :class:`BatchedServer` is one serving replica (tensor-parallel when
built with ``mesh=``: ``launch.mesh.make_serving_mesh``). This module
scales OUT: a :class:`ReplicaFrontend` takes a multi-tenant arrival
stream (``core.traffic`` traces), routes each request to a replica and
drives every replica's :class:`~repro_torch.launch.serve.ServeLoop` in
lockstep, so no replica decodes past the next global arrival, as a
request pending on one server caps its decode spans.

* **Routing** is prefix-cache affinity first: requests that carry a
  shared system prompt (a ``(tenant, prefix_id)`` key from the trace)
  stick to the replica that prefilled it, so its cached pages keep being
  aliased instead of prefilled N times. Affinity yields only when the
  favored replica's load score (its ``slo.queue_depth_ewma`` gauge,
  undelivered and queued work, slot occupancy, minus paged-pool
  headroom) exceeds the pool's best by ``rebalance_margin``.
* **SharedPrefixStore**: after each global round every replica's cached
  chains are published (host numpy copies, parents first) and installed
  into the other replicas' HOST tiers, where they take no device page
  until a hit promotes them. Entries are namespaced by page size and
  pool geometry, so pages flow only between identically shaped pools.

Identity contract: a 1-replica frontend is the plain server. Delivering
arrivals at the shared clock instead of up front is invisible
(``ServeLoop.tick(limit_step=next_arrival)`` caps spans exactly as the
request sitting in the loop's own pending list would), so
``ReplicaFrontend([srv]).run(reqs)`` gives ``srv.run(reqs)``'s tokens,
``done`` flags and finish steps bit for bit (the shared store is off at
one replica).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.page_store import PageBlob, cache_geometry, extract_page
from ..runtime.telemetry import MetricsRegistry
from .serve import BatchedServer, Request, ServeLoop


class SharedPrefixStore:
    """Cross-replica prefix-page exchange in the snapshot's wire format.

    Entries are keyed ``(page_size, geometry)`` then ``(profile_key,
    tokens)``, the snapshot header's namespacing: pages flow only between
    replicas whose pool geometry (containers, dtypes, head layout, a
    tensor-parallel rank's local heads included) matches, and chains
    quantized under different KV profiles never collide. Values are host
    ``PageBlob`` copies, published parents before children (the trie's
    DFS order), so an install always finds its ancestors."""

    def __init__(self):
        # namespace -> {(profile_key, tokens): PageBlob}; dicts keep
        # insertion order, which keeps the parents-first publish order
        self._chains: Dict[tuple, dict] = {}
        self.published = 0
        self.installed = 0

    def _namespace(self, srv: BatchedServer) -> tuple:
        return (srv.page_size, cache_geometry(srv.caches, scan=srv.kv_scan))

    def __len__(self) -> int:
        return sum(len(ns) for ns in self._chains.values())

    def publish(self, srv: BatchedServer) -> int:
        """Copy every cached chain page of ``srv`` not yet in the store,
        sourced as ``BatchedServer.snapshot_prefix_cache`` sources them
        (resident pages off the pools, demoted ones from the host tier,
        requantized ones widened back by the quant tier). Blobs are
        deep-copied to host numpy, so a later eviction in ``srv`` cannot
        touch them. Returns the pages published."""
        if srv.prefix_cache is None:
            return 0
        ns = self._chains.setdefault(self._namespace(srv), {})
        n = 0
        for key, tokens, node in srv.prefix_cache.iter_chain_nodes():
            ck = (key, tuple(int(t) for t in tokens))
            if ck in ns:
                continue
            if node.host is not None:
                blob = srv.host_store.get(node.host)
            elif node.tier is not None:
                blob = srv.quant_tier.export(node.tier)
            else:
                blob = extract_page(srv.caches, node.page, scan=srv.kv_scan)
            ns[ck] = PageBlob([{f: np.array(a) for f, a in rec.items()}
                               for rec in blob.arrays])
            n += 1
        self.published += n
        return n

    def install(self, srv: BatchedServer) -> int:
        """Land every store chain of ``srv``'s namespace that ``srv`` does
        not cache yet in its HOST tier (the snapshot-restore path: no
        device page until a hit promotes it). Stops when the host tier
        fills; duplicate and orphaned chains are skipped without keeping
        a handle. Returns the pages installed."""
        if srv.prefix_cache is None or srv.host_store is None:
            return 0
        ns = self._chains.get(self._namespace(srv), {})
        n = 0
        for (key, tokens), blob in ns.items():
            if not srv.host_store.has_room(1):
                break
            # a fresh PageBlob per replica (each host store may drop its
            # own); the numpy pages are never written, so they are shared
            h = srv.host_store.put(PageBlob([dict(r) for r in blob.arrays]))
            if srv.prefix_cache.insert_host(list(tokens), h, key):
                n += 1
            else:
                srv.host_store.drop(h)
        self.installed += n
        return n


def requests_from_trace(trace) -> Tuple[List[Request], List[Optional[tuple]]]:
    """A ``core.traffic.Trace`` as fresh serve ``Request``s and their
    affinity keys: ``(tenant, prefix_id)`` for arrivals drawn from a
    shared-prefix pool, None for prefix-less traffic (a Request is
    mutable run state, so every arm needs its own)."""
    reqs, keys = [], []
    for r in trace.requests:
        reqs.append(Request(r.rid, np.array(r.prompt), r.max_new,
                            priority=r.priority,
                            deadline_step=r.deadline_step,
                            arrive_step=r.arrive_step))
        keys.append((r.tenant, r.prefix_id) if r.prefix_id >= 0 else None)
    return reqs, keys


def aggregate_goodput(requests: Sequence[Request]) -> Optional[float]:
    """Pool-level goodput over every offered request on the decode-step
    clock, ``Tracer.slo_summary``'s accounting from the Request records
    alone: a deadlined request is good iff it finished unrejected by its
    ``deadline_step``, one without a deadline iff it finished."""
    if not requests:
        return None
    met = 0
    for r in requests:
        finished = r.done and r.error is None
        if r.deadline_step is None:
            met += bool(finished)
        else:
            met += bool(finished and r.finish_step is not None
                        and r.finish_step <= r.deadline_step)
    return met / len(requests)


class ReplicaFrontend:
    """Admission front over N serving replicas (see the module docstring).

    ``servers`` are built :class:`BatchedServer`s, typically from
    :func:`make_replicas`, each with its own namespaced registry.
    ``share_prefixes`` turns on the :class:`SharedPrefixStore` sync after
    every global round; it needs every replica to run the prefix cache
    and the host tier, and is off at one replica. ``rebalance_margin`` is
    how much worse, in load-score units (about one queued request or one
    fully busy batch), the sticky replica may be than the pool's best
    before affinity yields."""

    def __init__(self, servers: Sequence[BatchedServer], *,
                 share_prefixes: bool = True,
                 rebalance_margin: float = 2.0,
                 metrics: Optional[MetricsRegistry] = None):
        if not servers:
            raise ValueError("ReplicaFrontend needs at least one replica")
        self.servers = list(servers)
        self.loops: List[ServeLoop] = [s.start_loop([]) for s in servers]
        # the counters carry their "frontend." prefix, so this registry
        # stays un-namespaced and merges with the replicas' snapshots
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.affinity: Dict[tuple, int] = {}
        self.store = (SharedPrefixStore()
                      if share_prefixes and len(self.servers) > 1
                      and all(s.prefix_cache is not None
                              and s.host_store is not None
                              for s in self.servers) else None)
        self.rebalance_margin = rebalance_margin

    def load_score(self, i: int) -> float:
        """Replica i's routing load: the queue-depth EWMA gauge, plus
        undelivered and queued requests and slot occupancy, minus the
        paged pool's free share (a replica with free pages takes a routed
        prefill without evicting)."""
        srv, loop = self.servers[i], self.loops[i]
        g = srv.metrics.gauge
        score = float(g("slo.queue_depth_ewma").value)
        score += len(loop.queue) + len(loop.pending)
        score += sum(s is not None for s in srv.slots) / max(1, srv.B)
        if srv.paged:
            usable = float(g("kv.device_pages_usable").value)
            if usable > 0:
                score -= float(g("kv.device_pages_free").value) / usable
        return score

    def route(self, req: Request, key: Optional[tuple] = None) -> int:
        """The replica for ``req``: sticky on the affinity key while the
        favored replica's load stays within ``rebalance_margin`` of the
        pool's best, the least loaded otherwise."""
        n = len(self.servers)
        if n == 1:
            return 0
        best = min(range(n), key=self.load_score)
        r = self.affinity.get(key) if key is not None else None
        if r is not None:
            if self.load_score(r) - self.load_score(best) \
                    > self.rebalance_margin:
                self.affinity[key] = r = best
                self.metrics.counter("frontend.rebalanced").inc()
            else:
                self.metrics.counter("frontend.affinity_hits").inc()
        else:
            r = best
            if key is not None:
                self.affinity[key] = r
        return r

    def _deliver(self, req: Request, key: Optional[tuple]) -> int:
        r = self.route(req, key)
        self.loops[r].add(req)
        self.metrics.counter("frontend.routed").inc()
        self.metrics.counter(f"frontend.routed_replica{r}").inc()
        return r

    def _sync_store(self) -> None:
        if self.store is None:
            return
        for srv in self.servers:
            self.store.publish(srv)
        n = sum(self.store.install(srv) for srv in self.servers)
        if n:
            self.metrics.counter("frontend.shared_prefix_pages").inc(n)

    def run(self, requests: Sequence[Request],
            keys: Optional[Sequence[Optional[tuple]]] = None
            ) -> List[Request]:
        """Serve ``requests`` to completion across the pool.

        The shared clock jumps arrival to arrival: every request with
        ``arrive_step`` <= the slowest replica's clock goes to its routed
        replica, then each unfinished loop ticks with ``limit_step`` = the
        next global arrival until its clock reaches it. Once arrivals run
        out the replicas drain on their own. Returns ``requests``, which
        now carry out / done / finish_step, as ``BatchedServer.run``."""
        if keys is None:
            keys = [None] * len(requests)
        if len(keys) != len(requests):
            raise ValueError("keys must parallel requests")
        pending = sorted(zip(requests, keys),
                         key=lambda rk: rk[0].arrive_step)
        while True:
            t = min(loop.clock for loop in self.loops)
            while pending and pending[0][0].arrive_step <= t:
                req, key = pending.pop(0)
                self._deliver(req, key)
            na = pending[0][0].arrive_step if pending else None
            for loop in self.loops:
                while not loop.finished and (na is None or loop.clock < na):
                    loop.tick(limit_step=na)
            if pending:
                # every replica reached the arrival step
                self._sync_store()
                continue
            if all(loop.finished for loop in self.loops):
                break
        for loop in self.loops:
            loop.close()
        self._sync_store()
        return list(requests)


def make_replicas(n: int, cfg, model, **server_kwargs
                  ) -> List[BatchedServer]:
    """``n`` identical replicas over ONE ``model`` (the weights are not
    copied), each with its own namespaced registry (``replica0`` ...: the
    merged snapshot keeps the replicas' ``slo.*`` / ``kv.*`` streams
    apart). ``server_kwargs`` go to every :class:`BatchedServer` as they
    are; pass ``mesh=`` for tensor-parallel replicas."""
    if n < 1:
        raise ValueError("need at least one replica")
    if "registry" in server_kwargs:
        raise ValueError("make_replicas owns the per-replica registries")
    return [BatchedServer(cfg, model,
                          registry=MetricsRegistry(namespace=f"replica{i}"),
                          **server_kwargs)
            for i in range(n)]


def merged_snapshot(frontend: ReplicaFrontend) -> dict:
    """The frontend's counters merged with every replica's namespaced
    snapshot (``replica0.slo.window_goodput`` ...), one JSON-ready dict:
    the multi-replica ``MetricsRegistry.snapshot``."""
    out = frontend.metrics.snapshot()
    for srv in frontend.servers:
        snap = srv.metrics.snapshot()
        for section in ("counters", "gauges", "histograms"):
            out[section].update(snap[section])
    return out
