"""A bounded slice of device activity from ``torch.profiler`` (CUDA only),
read from kineto's events; the union of their intervals gives the busy
time. The profiler's clock is tied to the host's ``perf_counter`` by a
marker kernel launched on an idle device at both ends of the slice, so
each idle gap can be labelled with what the host was doing then (the
drivers record their host phases as (label, start, end) intervals)."""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

MARKER = "spin_kernel"     # the kernel of torch.cuda._sleep


def device_events(prof) -> List[Tuple[str, float, float]]:
    """A closed profiler's device events as (name, start s, end s) on the
    profiler's clock (kineto's events, without building the profiler's
    Python event tree)."""
    cuda = torch.autograd.DeviceType.CUDA
    res = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if res is not None:
        return [(e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
                for e in res.events() if e.device_type() == cuda]
    return [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            for e in prof.events() if e.device_type == cuda]


def union(spans: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceSlice:
    """``start()`` / ``stop()`` around a slice of a run; then ``busy_s``,
    ``window_s``, ``by_name`` (name -> seconds) and ``gaps`` (idle
    intervals on the host clock)."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = None
        self._marks: List[float] = []

    def _mark(self) -> None:
        torch.cuda.synchronize()
        self._marks.append(time.perf_counter())
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        if not self.cuda:
            # no device to trace (the CPU path in tests): host times only
            self.t0 = time.perf_counter()
            return
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._mark()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.cuda:
            self.t1 = time.perf_counter()
            self.window_s, self.busy_s, self.offset_s = self.t1 - self.t0, 0.0, 0.0
            self.events, self.by_name, self.gaps = [], {}, []
            self.markers = 0
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._mark()
        self.prof.stop()
        evs = device_events(self.prof)
        self.prof = None
        self.read(evs)

    def read(self, evs: Sequence[Tuple[str, float, float]]) -> None:
        """The slice's device events (profiler clock) against its host
        window [t0, t1]. The device is idle at both ends (a sync and a
        marker kernel), so every event but the markers lies inside the
        window: busy time and time by name need no clock. The offset
        between the clocks, which places the idle gaps on the host's clock,
        comes from the markers: from both, or from the one recorded (the
        profiler does not always record both), or, with none, from taking
        the first event to start at t0."""
        marks = sorted(s for n, s, _ in evs if MARKER in n)
        work = [(n, s, e) for n, s, e in evs if MARKER not in n]
        self.markers = len(marks)
        if len(marks) >= 2:
            off = ((marks[0] - self._marks[0])
                   + (marks[-1] - self._marks[-1])) / 2
        elif marks and work:
            at_start = marks[0] <= min(s for _, s, _ in work)
            off = marks[0] - self._marks[0 if at_start else -1]
        elif work:
            off = min(s for _, s, _ in work) - self.t0
        else:
            off = 0.0
        self.offset_s = off
        lo, hi = self.t0 + off, self.t1 + off
        self.events = [(n, max(s, lo) - off, min(e, hi) - off)
                       for n, s, e in work if e > lo and s < hi]
        self.window_s = self.t1 - self.t0
        busy = union([(s, e) for _, s, e in self.events])
        self.busy_s = sum(e - s for s, e in busy)
        self.by_name: Dict[str, float] = {}
        for n, s, e in self.events:
            self.by_name[n] = self.by_name.get(n, 0.0) + (e - s)
        edges = [self.t0] + [x for s, e in busy for x in (s, e)] + [self.t1]
        self.gaps = [(edges[i], edges[i + 1])
                     for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_by_phase(self, phases: Sequence[Tuple[str, float, float]],
                      n: int = 10) -> List[list]:
        """Idle seconds of the slice summed by the host phase that overlaps
        each gap most, the innermost (shortest) phase on a tie ("other"
        where none does), largest first. One sweep over the gaps and the
        phases, both in time order."""
        out: Dict[str, float] = {}
        ph = sorted((p for p in phases if p[2] > self.t0 and p[1] < self.t1),
                    key=lambda p: p[1])
        i, open_ = 0, []
        for g0, g1 in self.gaps:
            while i < len(ph) and ph[i][1] < g1:
                open_.append(ph[i])
                i += 1
            open_ = [p for p in open_ if p[2] > g0]
            best, lab = (0.0, 0.0), "other"
            for label, p0, p1 in open_:
                key = (min(g1, p1) - max(g0, p0), -(p1 - p0))
                if key[0] > 0 and key > best:
                    best, lab = key, label
            out[lab] = out.get(lab, 0.0) + (g1 - g0)
        return [[k, v] for k, v in sorted(out.items(),
                                          key=lambda kv: -kv[1])[:n]]


class Phases:
    """Host phases as (label, start, end) on ``perf_counter``; ``on``
    False records nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.spans: List[Tuple[str, float, float]] = []

    def wrap(self, label: str, fn):
        if not self.on:
            return fn

        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((label, t0, time.perf_counter()))
        return wrapped

    def add(self, label: str, t0: float, t1: Optional[float] = None):
        if self.on:
            self.spans.append((label, t0, time.perf_counter()
                               if t1 is None else t1))
