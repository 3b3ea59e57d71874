"""Serving telemetry: the metrics registry and the disabled tracer.

The subset of ``repro.runtime.telemetry`` that ``BatchedServer`` reads with
metrics off: named counters/gauges/histograms in one injectable registry,
the ``metric_attr`` descriptor that maps legacy counter attributes onto it,
the no-op tracer, and the rolling-window ``SLOMonitor`` the server always
feeds. All of it is host bookkeeping and never touches device tensors. The
live span tracer, the JSONL snapshotter and ``--metrics on`` are still to
port (ROADMAP queue A item 8).
"""
from __future__ import annotations

import collections
import math
import time
from typing import Callable, Dict, List, Optional


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


class Gauge:
    """Current-state value read from a zero-arg callback (0 until one is
    bound with ``MetricsRegistry.register_gauge``)."""

    __slots__ = ("name", "_v", "fn")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self._v = 0.0
        self.fn = fn

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


class MetricsRegistry:
    """Injectable named-metric store; metrics are created on first access."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

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


class _NullSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The metrics-off tracer: the tracer surface the server calls, every
    method a no-op."""

    enabled = False

    def span(self, name, *, tid=0, args=None):
        return _NULL_SPAN

    def req_arrive(self, rid, step, deadline_step=None):
        pass

    def req_admit(self, rid, step, *, resumed=False):
        pass

    def req_defer(self, rid, step):
        pass

    def req_reject(self, rid, step, reason=""):
        pass

    def req_first_token(self, rid):
        pass

    def req_finish(self, rid, step, tokens):
        pass


def make_tracer(mode: str):
    """``"off"`` -> :class:`NullTracer`. The live tracer (``"on"``) is
    still to port."""
    if mode == "on":
        raise NotImplementedError(
            "metrics on (the live span tracer) is not ported yet: ROADMAP "
            "queue A item 8")
    if mode != "off":
        raise ValueError(f"metrics mode must be 'on' or 'off', got {mode!r}")
    return NullTracer()
