"""Serving telemetry: the metrics registry, the span tracer and the
JSONL metrics stream.

* :class:`MetricsRegistry` — named counters, gauges (values or zero-arg
  callbacks read live) and all-samples histograms with exact nearest-rank
  percentiles, one injectable registry per server; :class:`metric_attr`
  maps legacy counter attributes onto it. ``reset`` (counters zeroed in
  place, histograms cleared, gauges kept) and ``checkpoint`` / ``since``
  mark a bench's warm-up boundary.
* :class:`Tracer` (``--metrics on``) — Chrome trace-event spans and
  instants on ``time.perf_counter``, with per-request lifecycle records
  (arrive -> admit / defer / reject -> first token -> finish) reduced to
  TTFT, TPOT and goodput by :meth:`Tracer.slo_summary`. Track layout: pid
  0; tid 0 the engine, tid 1 + rid one track per request, tid
  :data:`PAGER_TID` the tiered pager's transfers (:meth:`Tracer.pager_span`).
* :class:`NullTracer` (``--metrics off``) — the same surface, every method
  a no-op.
* :class:`SLOMonitor` — rolling-window SLO gauges the server always feeds.
* :class:`MetricsSnapshotter` — one registry snapshot a JSONL line every
  N scheduler cycles.

All of it is host bookkeeping: nothing here reads or syncs a device
tensor, so tracing cannot change tokens. On a card a span's duration is
host time (the device runs behind it), except for a span that ends at a
sync the serving loop already makes (``decode_span`` ends at its token
download); a pager span of an async transfer runs from its issue to the
drain that found it complete.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import math
import time
from typing import Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

# the Chrome-trace track of the pager's transfers: far above any 1 + rid
# request track, since its spans overlap the engine's decode spans
PAGER_TID = 1_000_000


def percentile(values, p: float):
    """Exact nearest-rank percentile of ``values`` (None when empty)."""
    if not values:
        return None
    xs = sorted(values)
    k = max(1, math.ceil(p / 100.0 * len(xs)))
    return xs[min(k, len(xs)) - 1]


def _as_number(v: float):
    """Ints stay ints in reads (counters are mostly counts)."""
    return int(v) if float(v).is_integer() else float(v)


class Counter:
    """A named counter; ``value`` may also be assigned (``metric_attr``)."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def inc(self, n: float = 1) -> None:
        self._v += n

    @property
    def value(self):
        return _as_number(self._v)

    @value.setter
    def value(self, v: float) -> None:
        self._v = float(v)

    def reset(self) -> None:
        self._v = 0.0


class Gauge:
    """Current-state value read from a zero-arg callback (0 until one is
    bound with ``MetricsRegistry.register_gauge``)."""

    __slots__ = ("name", "_v", "fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._v = 0.0
        self.fn = fn

    def set(self, v: float) -> None:
        self._v = float(v)

    @property
    def value(self):
        return _as_number(self.fn() if self.fn is not None else self._v)


class Histogram:
    """All-samples histogram with exact nearest-rank percentiles."""

    __slots__ = ("name", "values")

    def __init__(self, name: str):
        self.name = name
        self.values: List[float] = []

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    @property
    def count(self) -> int:
        return len(self.values)

    def percentile(self, p: float):
        return percentile(self.values, p)

    def summary(self) -> dict:
        n = len(self.values)
        if n == 0:
            return {"count": 0}
        return {"count": n, "mean": sum(self.values) / n,
                "min": min(self.values), "max": max(self.values),
                "p50": self.percentile(50), "p99": self.percentile(99)}

    def reset(self) -> None:
        self.values = []


class MetricsRegistry:
    """Injectable named-metric store; metrics are created on first access.

    ``namespace`` prefixes every name in the exported view
    (:meth:`snapshot`, :meth:`export_name`) only: components read and
    write unprefixed names, so a server reads ``gauge("slo.x")`` alike
    standalone or as one replica of a frontend (``replica0`` ...)."""

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def export_name(self, name: str) -> str:
        return f"{self.namespace}.{name}" if self.namespace else name

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def register_gauge(self, name: str, fn: Callable[[], float]) -> Gauge:
        """(Re)bind gauge ``name`` to a live zero-arg callback."""
        g = self.gauge(name)
        g.fn = fn
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    def value(self, name: str):
        """Read any metric by name (counter > gauge > histogram count)."""
        if name in self._counters:
            return self._counters[name].value
        if name in self._gauges:
            return self._gauges[name].value
        if name in self._histograms:
            return self._histograms[name].count
        raise KeyError(f"unknown metric {name!r}")

    def snapshot(self) -> dict:
        """One JSON-ready view of every metric (gauge callbacks read),
        its names carrying the ``namespace`` prefix, if any."""
        ns = self.export_name
        return {
            "counters": {ns(n): c.value
                         for n, c in sorted(self._counters.items())},
            "gauges": {ns(n): g.value
                       for n, g in sorted(self._gauges.items())},
            "histograms": {ns(n): h.summary()
                           for n, h in sorted(self._histograms.items())},
        }

    def checkpoint(self) -> dict:
        """The counters' current values (a warm-up boundary); :meth:`since`
        reads the deltas after it without zeroing anything."""
        return {n: c.value for n, c in self._counters.items()}

    def since(self, checkpoint: dict) -> dict:
        """Counter deltas accumulated after ``checkpoint``."""
        return {n: _as_number(c.value - checkpoint.get(n, 0))
                for n, c in sorted(self._counters.items())}

    def reset(self) -> None:
        """Zero every counter in place (held ``Counter`` objects and
        ``metric_attr`` attributes keep working) and clear every histogram.
        Gauges are state, not accumulation, and are left alone."""
        for c in self._counters.values():
            c.reset()
        for h in self._histograms.values():
            h.reset()


_DEFAULT: Optional[MetricsRegistry] = None


def default_registry() -> MetricsRegistry:
    """The process-wide registry, for components no server owns; the
    serving path injects its own (two servers in one process must not
    share counters)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = MetricsRegistry()
    return _DEFAULT


class metric_attr:
    """Data descriptor mapping an instance attribute onto a registry
    counter, so ``obj.prefill_forwards += 1`` writes the registry."""

    __slots__ = ("name", "registry_attr")

    def __init__(self, name: str, registry_attr: str = "metrics"):
        self.name = name
        self.registry_attr = registry_attr

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return getattr(obj, self.registry_attr).counter(self.name).value

    def __set__(self, obj, value) -> None:
        getattr(obj, self.registry_attr).counter(self.name).value = value


class Ewma:
    """Exponentially-weighted moving average (None until the first update)."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = (float(x) if self.value is None
                      else self.alpha * float(x)
                      + (1.0 - self.alpha) * self.value)
        return self.value

    def get(self, default: float = 0.0) -> float:
        return default if self.value is None else self.value


class SLOMonitor:
    """Rolling-window SLO reductions, live during a run.

    Keeps bounded deques of the last ``window`` finished requests and EWMAs
    of the queue/arrival/TPOT signals, registered as ``slo.*`` gauges.
    Host-side only: feeding it cannot change tokens."""

    def __init__(self, registry: MetricsRegistry, window: int = 32,
                 alpha: float = 0.2):
        if window < 1:
            raise ValueError("window must be >= 1 request")
        self.registry = registry
        self.window = window
        self._ttft = collections.deque(maxlen=window)
        self._tpot = collections.deque(maxlen=window)
        self._met = collections.deque(maxlen=window)
        self._arrive_ts: Dict[int, float] = {}
        self._first_ts: Dict[int, float] = {}
        self.queue_depth = Ewma(alpha)
        self.arrival_rate = Ewma(alpha / 2)
        self.tpot = Ewma(alpha)
        self.tpot_ref = Ewma(alpha / 10)   # the run's own baseline speed
        self._pending_arrivals = 0
        g = registry.register_gauge
        g("slo.window_requests", lambda: len(self._met))
        g("slo.window_goodput", lambda: self.window_goodput() or 0.0)
        g("slo.window_ttft_p50_s", lambda: self.window_ttft(50) or 0.0)
        g("slo.window_ttft_p99_s", lambda: self.window_ttft(99) or 0.0)
        g("slo.window_tpot_p50_s", lambda: self.window_tpot(50) or 0.0)
        g("slo.window_tpot_p99_s", lambda: self.window_tpot(99) or 0.0)
        g("slo.queue_depth_ewma", lambda: self.queue_depth.get())
        g("slo.arrival_rate_ewma", lambda: self.arrival_rate.get())
        g("slo.tpot_ewma_s", lambda: self.tpot.get())

    def note_arrive(self, rid: int) -> None:
        self._arrive_ts[rid] = time.perf_counter()
        self._pending_arrivals += 1

    def note_first_token(self, rid: int) -> None:
        t0 = self._arrive_ts.get(rid)
        if t0 is not None and rid not in self._first_ts:
            now = time.perf_counter()
            self._first_ts[rid] = now
            self._ttft.append(now - t0)

    def note_finish(self, rid: int, met: bool, tokens: int) -> None:
        """Finish OR reject (met=False) — one window sample either way."""
        first = self._first_ts.pop(rid, None)
        self._arrive_ts.pop(rid, None)
        if first is not None and tokens > 1:
            tpot = (time.perf_counter() - first) / (tokens - 1)
            self._tpot.append(tpot)
            self.tpot.update(tpot)
            self.tpot_ref.update(tpot)
        self._met.append(bool(met))

    def note_queue_depth(self, depth: int) -> None:
        self.queue_depth.update(depth)

    def advance(self, steps: int) -> None:
        """Fold arrivals seen since the last call into the arrival-rate
        EWMA; called once per scheduler cycle."""
        if steps > 0:
            self.arrival_rate.update(self._pending_arrivals / steps)
            self._pending_arrivals = 0

    def window_goodput(self) -> Optional[float]:
        if not self._met:
            return None
        return sum(self._met) / len(self._met)

    def window_ttft(self, p: float) -> Optional[float]:
        return percentile(list(self._ttft), p)

    def window_tpot(self, p: float) -> Optional[float]:
        return percentile(list(self._tpot), p)

    def tpot_slowdown(self) -> float:
        """Fast over slow TPOT EWMA, minus 1, clipped to [-0.25, 0.25]: the
        deadline-miss predictor's one wall-clock feature, kept small so
        timing jitter cannot outweigh its decode-step-clock features."""
        if self.tpot.value is None or not self.tpot_ref.get():
            return 0.0
        r = self.tpot.value / self.tpot_ref.value - 1.0
        return max(-0.25, min(0.25, r))


# ---------------------------------------------------------------------------
# Span tracer (Chrome trace-event JSON) + per-request lifecycle records
# ---------------------------------------------------------------------------
class _RequestRecord:
    """One request incarnation: offering the same rid again opens a fresh
    record."""

    __slots__ = ("rid", "arrive_ts", "arrive_step", "deadline_step",
                 "admit_ts", "admit_step", "first_token_ts", "finish_ts",
                 "finish_step", "tokens", "rejected", "resumed",
                 "preemptions", "defers")

    def __init__(self, rid: int, ts: float, step: int,
                 deadline_step: Optional[int]):
        self.rid = rid
        self.arrive_ts = ts
        self.arrive_step = step
        self.deadline_step = deadline_step
        self.admit_ts: Optional[float] = None
        self.admit_step: Optional[int] = None
        self.first_token_ts: Optional[float] = None
        self.finish_ts: Optional[float] = None
        self.finish_step: Optional[int] = None
        self.tokens = 0
        self.rejected = False
        self.resumed = 0
        self.preemptions = 0
        self.defers = 0


class Tracer:
    """Span-based request-lifecycle tracer on a monotonic clock.

    Events are Chrome trace-event dicts, timestamps in microseconds since
    the tracer was made: ``X`` complete spans (:meth:`span`,
    :meth:`req_span`), ``i`` instants (:meth:`instant` and the ``req_*``
    lifecycle calls) and ``M`` track names. ``args.step`` carries the
    decode-step clock where known, so goodput follows from the trace
    alone. Host bookkeeping only: it never reads a device tensor."""

    enabled = True

    def __init__(self, name: str = "serve"):
        self._t0 = time.perf_counter()
        self.events: List[dict] = []
        self._named_tracks = set()
        self._reqs: List[_RequestRecord] = []
        self._open: Dict[int, _RequestRecord] = {}
        self.events.append({"ph": "M", "name": "process_name", "pid": 0,
                            "tid": 0, "args": {"name": name}})
        self._track_name(0, "engine")

    # -- low-level events ---------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _track_name(self, tid: int, name: str) -> None:
        if tid in self._named_tracks:
            return
        self._named_tracks.add(tid)
        self.events.append({"ph": "M", "name": "thread_name", "pid": 0,
                            "tid": tid, "args": {"name": name}})

    def instant(self, name: str, *, tid: int = 0,
                args: Optional[dict] = None) -> None:
        ev = {"ph": "i", "name": name, "pid": 0, "tid": tid,
              "ts": self._now_us(), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, tid: int = 0,
             args: Optional[dict] = None):
        """Record one ``X`` complete event around the body."""
        t0 = self._now_us()
        try:
            yield
        finally:
            ev = {"ph": "X", "name": name, "pid": 0, "tid": tid,
                  "ts": t0, "dur": max(0.0, self._now_us() - t0)}
            if args:
                ev["args"] = args
            self.events.append(ev)

    def pager_span(self, name: str, t_start: float, t_end: float,
                   args: Optional[dict] = None) -> None:
        """Record a retrospective span on the pager track from two
        ``time.perf_counter`` stamps: an async transfer is issued mid-cycle
        and its end is known only at the next drain, so the span is closed
        after the fact. It lands on :data:`PAGER_TID` because these spans
        overlap the engine's decode spans by design."""
        self._track_name(PAGER_TID, "pager")
        ev = {"ph": "X", "name": name, "pid": 0, "tid": PAGER_TID,
              "ts": max(0.0, (t_start - self._t0) * 1e6),
              "dur": max(0.0, (t_end - t_start) * 1e6)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- request lifecycle --------------------------------------------------
    def _rec(self, rid: int) -> Optional[_RequestRecord]:
        return self._open.get(rid)

    def _req_tid(self, rid: int) -> int:
        tid = 1 + rid
        self._track_name(tid, f"req {rid}")
        return tid

    def req_span(self, rid: int, name: str, args: Optional[dict] = None):
        return self.span(name, tid=self._req_tid(rid), args=args)

    def _req_instant(self, rid: int, name: str, step: Optional[int],
                     **extra) -> None:
        args = dict(extra)
        if step is not None:
            args["step"] = step
        self.instant(name, tid=self._req_tid(rid), args=args or None)

    def req_arrive(self, rid: int, step: int,
                   deadline_step: Optional[int] = None) -> None:
        rec = _RequestRecord(rid, time.perf_counter(), step, deadline_step)
        self._reqs.append(rec)
        self._open[rid] = rec
        self._req_instant(rid, "arrive", step, deadline=deadline_step)

    def req_admit(self, rid: int, step: int, *,
                  resumed: bool = False) -> None:
        rec = self._rec(rid)
        if rec is not None:
            if resumed:
                rec.resumed += 1
            elif rec.admit_ts is None:
                rec.admit_ts = time.perf_counter()
                rec.admit_step = step
        self._req_instant(rid, "resume" if resumed else "admit", step)

    def req_defer(self, rid: int, step: int) -> None:
        rec = self._rec(rid)
        if rec is not None:
            rec.defers += 1
        self._req_instant(rid, "defer", step)

    def req_reject(self, rid: int, step: int, reason: str = "") -> None:
        rec = self._open.pop(rid, None)
        if rec is not None:
            rec.rejected = True
            rec.finish_ts = time.perf_counter()
            rec.finish_step = step
        self._req_instant(rid, "reject", step, reason=reason)

    def req_preempt(self, rid: int, step: int) -> None:
        rec = self._rec(rid)
        if rec is not None:
            rec.preemptions += 1
        self._req_instant(rid, "preempt", step)

    def req_first_token(self, rid: int) -> None:
        rec = self._rec(rid)
        if rec is not None and rec.first_token_ts is None:
            rec.first_token_ts = time.perf_counter()
        self._req_instant(rid, "first_token", None)

    def req_finish(self, rid: int, step: int, tokens: int) -> None:
        rec = self._open.pop(rid, None)
        if rec is not None:
            rec.finish_ts = time.perf_counter()
            rec.finish_step = step
            rec.tokens = tokens
        self._req_instant(rid, "finish", step, tokens=tokens)

    # -- SLO reduction ------------------------------------------------------
    def request_stats(self) -> List[dict]:
        """Per-incarnation lifecycle metrics: TTFT and TPOT on the wall
        clock, the deadline outcome on the decode-step clock."""
        out = []
        for r in self._reqs:
            finished = r.finish_ts is not None and not r.rejected
            ttft = (r.first_token_ts - r.arrive_ts
                    if r.first_token_ts is not None else None)
            tpot = None
            if finished and r.first_token_ts is not None and r.tokens > 1:
                tpot = (r.finish_ts - r.first_token_ts) / (r.tokens - 1)
            if r.deadline_step is None:
                met = finished
            else:
                met = (finished and r.finish_step is not None
                       and r.finish_step <= r.deadline_step)
            out.append({"rid": r.rid, "arrive_step": r.arrive_step,
                        "deadline_step": r.deadline_step,
                        "finish_step": r.finish_step, "tokens": r.tokens,
                        "finished": finished, "rejected": r.rejected,
                        "preemptions": r.preemptions, "defers": r.defers,
                        "resumed": r.resumed,
                        "ttft_s": ttft, "tpot_s": tpot,
                        "met_deadline": met})
        return out

    def slo_summary(self) -> dict:
        """p50/p99 TTFT and TPOT and goodput over every offered request. A
        request is good when it finished unrejected by its
        ``deadline_step`` (decode-step clock); without a deadline, when it
        finished."""
        stats = self.request_stats()
        ttfts = [s["ttft_s"] for s in stats if s["ttft_s"] is not None]
        tpots = [s["tpot_s"] for s in stats if s["tpot_s"] is not None]
        n = len(stats)
        return {
            "requests": n,
            "finished": sum(1 for s in stats if s["finished"]),
            "rejected": sum(1 for s in stats if s["rejected"]),
            "preemptions": sum(s["preemptions"] for s in stats),
            "deadlined": sum(1 for s in stats
                             if s["deadline_step"] is not None),
            "deadline_misses": sum(
                1 for s in stats
                if s["deadline_step"] is not None and not s["met_deadline"]),
            "goodput": (sum(1 for s in stats if s["met_deadline"]) / n
                        if n else None),
            "ttft_p50_s": percentile(ttfts, 50),
            "ttft_p99_s": percentile(ttfts, 99),
            "tpot_p50_s": percentile(tpots, 50),
            "tpot_p99_s": percentile(tpots, 99),
        }

    # -- export -------------------------------------------------------------
    def chrome_trace(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        """Write ``chrome://tracing`` / Perfetto JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The metrics-off tracer: the :class:`Tracer` surface, every method a
    no-op, no clock read."""

    enabled = False
    events: List[dict] = []

    def instant(self, name, *, tid=0, args=None):
        pass

    def span(self, name, *, tid=0, args=None):
        return _NULL_SPAN

    def req_span(self, rid, name, args=None):
        return _NULL_SPAN

    def req_arrive(self, rid, step, deadline_step=None):
        pass

    def req_admit(self, rid, step, *, resumed=False):
        pass

    def req_defer(self, rid, step):
        pass

    def req_reject(self, rid, step, reason=""):
        pass

    def req_preempt(self, rid, step):
        pass

    def req_first_token(self, rid):
        pass

    def req_finish(self, rid, step, tokens):
        pass

    def request_stats(self):
        return []

    def slo_summary(self):
        return {}

    def chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def pager_span(self, name, t_start, t_end, args=None):
        pass

    def export_chrome(self, path):
        """Writes nothing: warns and returns None."""
        logger.warning("tracing is disabled (--metrics off); "
                       "export_chrome(%r) wrote nothing — enable "
                       "--metrics on to export a trace", path)
        return None


def make_tracer(mode: str, name: str = "serve"):
    """``"on"`` -> a live :class:`Tracer`, ``"off"`` -> :class:`NullTracer`."""
    if mode not in ("on", "off"):
        raise ValueError(f"metrics mode must be 'on' or 'off', got {mode!r}")
    return Tracer(name) if mode == "on" else NullTracer()


class MetricsSnapshotter:
    """Periodic JSONL metrics stream: one ``registry.snapshot()`` line per
    ``every`` scheduler cycles (plus each explicit :meth:`emit`), with the
    cycle count and the seconds since the snapshotter was made. The file
    is opened in append mode."""

    def __init__(self, registry: MetricsRegistry, path: str,
                 every: int = 50):
        if every < 1:
            raise ValueError("snapshot interval must be >= 1 cycle")
        self.registry = registry
        self.path = path
        self.every = every
        self._last = -1
        self._t0 = time.perf_counter()

    def maybe_emit(self, cycle: int) -> bool:
        """Emit iff ``cycle`` entered a new ``every``-sized window."""
        if cycle // self.every == self._last // self.every \
                and self._last >= 0:
            return False
        self.emit(cycle)
        return True

    def emit(self, cycle: int) -> None:
        self._last = cycle
        line = {"cycle": cycle,
                "elapsed_s": time.perf_counter() - self._t0}
        line.update(self.registry.snapshot())
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")
