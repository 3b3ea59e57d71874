"""Priority + SLO-aware admission scheduling and preemption policy.

The FIFO ``_admit`` loop of :class:`repro_torch.launch.serve.BatchedServer`
has a head-of-line problem: one request whose page demand cannot be met
right now blocks every request behind it, even ones that would fit
immediately. This module is the POLICY side of the replacement — pure
decision functions over request metadata, no server state mutated — and
the server is the MECHANISM (it executes admissions, demotions and
preemptions through the tiered page store).

Ordering is (priority, deadline, arrival): higher ``Request.priority``
first, then earliest ``deadline_step`` (EDF inside a priority class; a
request without a deadline sorts after every deadlined one), then arrival
order. On top of the ordering:

* **bounded out-of-order admission** — when the queue head must defer for
  pages, up to ``admit_window`` requests past it may still be examined and
  admitted if they fit, so the head blocks the *pages* it is waiting for,
  not the whole queue;
* **preemption** — a queued request strictly more urgent than a running one
  may evict it: the victim's written pages demote to the host tier, the
  victim re-queues (its position in the order is unchanged — it is less
  urgent by construction, so it cannot immediately preempt back), and on
  re-admission its pages promote back and decoding resumes bitwise
  identically (no re-prefill). Victims are chosen least-urgent-first and
  only when the freed pages actually make the preemptor admissible.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Tuple

from ..runtime.telemetry import MetricsRegistry, metric_attr

_NO_DEADLINE = float("inf")


@dataclasses.dataclass(frozen=True)
class SchedPolicy:
    """Knobs for the SLO scheduler.

    ``admit_window``: how many requests past a deferred head admission may
    examine per cycle (0 = strict FIFO order, just priority-sorted).
    ``preempt``: allow evicting running requests for strictly more urgent
    queued ones (needs the host-memory tier to park victim pages).
    ``max_preempt_per_admit``: cap on victims per admission cycle — bounds
    demotion burst latency under adversarial priority traffic.
    """

    admit_window: int = 4
    preempt: bool = True
    max_preempt_per_admit: int = 2


def request_key(req) -> Tuple[int, float, int, int]:
    """Total urgency order: smaller sorts first (more urgent)."""
    deadline = (_NO_DEADLINE if req.deadline_step is None
                else float(req.deadline_step))
    return (-req.priority, deadline, req.arrive_step, req.rid)


class SLOScheduler:
    """Stateless-ish policy object (holds only the knobs + counters)."""

    # registry-backed legacy attribute (see runtime.telemetry.metric_attr)
    ooo_admissions = metric_attr("sched.ooo_admissions")

    def __init__(self, policy: Optional[SchedPolicy] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.policy = policy or SchedPolicy()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.ooo_admissions = 0   # admissions past a deferred head

    def sort_queue(self, queue: List) -> None:
        """Stable-sort the queue most-urgent-first (priority, EDF,
        arrival)."""
        queue.sort(key=request_key)

    def choose_victims(self, req, running: List[Tuple[int, object, int]],
                       shortfall: int, gain: Callable[[int], int],
                       limit: Optional[int] = None) -> List[int]:
        """Pick slots to preempt so ``req`` becomes admissible.

        ``running`` is ``[(slot, request, _)]`` for live slots eligible for
        preemption (the server pre-filters e.g. host-tier room);
        ``shortfall`` is the page deficit after normal reclaim;
        ``gain(slot)`` the device pages a preemption of that slot would
        actually recover (refcount-1 pages + released reservation);
        ``limit`` the admission cycle's REMAINING victim budget (capped by
        ``max_preempt_per_admit`` either way). Only STRICTLY less urgent
        victims are eligible, least urgent first, and the empty list is
        returned unless the accumulated gain covers the shortfall — half a
        preemption buys nothing but churn.
        """
        if not self.policy.preempt:
            return []
        cap = self.policy.max_preempt_per_admit
        if limit is not None:
            cap = min(cap, limit)
        rk = request_key(req)
        eligible = [(slot, r) for slot, r, _ in running
                    if request_key(r) > rk]
        eligible.sort(key=lambda sr: request_key(sr[1]), reverse=True)
        victims, got = [], 0
        for slot, _ in eligible[:cap]:
            victims.append(slot)
            got += gain(slot)
            if got >= shortfall:
                return victims
        return []


# ---------------------------------------------------------------------------
# Telemetry-driven deadline-miss prediction
# ---------------------------------------------------------------------------
class DeadlineMissPredictor:
    """Online logistic model over live SLO telemetry, consulted every
    admission cycle to throttle SPECULATIVE work before pressure turns
    into deadline misses.

    Features (normalized to ~[0, 1]; all but the last live on the
    deterministic decode-step clock, and the wall-clock TPOT slowdown is
    pre-clipped small by ``SLOMonitor.tpot_slowdown`` so scheduling
    decisions replay identically run to run):

    * ``queue``    — deadlined requests waiting, / 2·batch
    * ``arrivals`` — per-step arrival-rate EWMA vs batch capacity
    * ``pressure`` — 1 − free-page headroom fraction (after reservations)
    * ``debt``     — queued deadlined prompt tokens vs one cycle's
      prefill capacity (batch · bucket)
    * ``occupancy``— live rows / batch
    * ``tpot``     — observed decode slowdown (wall, clipped ±0.25)

    The initial weights ARE a sensible threshold policy (risk crosses the
    gate once queue + arrival intensity + page pressure outweigh the
    bias), so the gate works from cycle 0; SGD on observed outcomes
    (label: the request retired past its ``deadline_step``) then adapts
    the threshold to the serving point's real capacity.

    The *gate decision* combines instantaneous risk with a peak-hold
    ``hazard`` (decayed per consultation): bursty arrivals cluster, so
    one observed overload episode keeps speculative admission throttled
    across the burst's inter-arrival gaps instead of re-admitting
    throughput traffic into the eye of the next wave. Deadlined requests
    are NEVER gated — the predictor only resizes the speculative share
    of the batch (no-deadline / paused-free rows), which costs those
    requests nothing: they carry no deadline, so goodput counts them
    whenever they finish.
    """

    FEATURES = ("bias", "queue", "arrivals", "pressure", "debt",
                "occupancy", "tpot")

    # registry-backed counters
    updates = metric_attr("sched.predictor_updates")
    gated = metric_attr("sched.predictor_gated")

    def __init__(self, metrics: Optional[MetricsRegistry] = None, *,
                 lr: float = 0.05, gate_at: float = 0.5,
                 hazard_decay: float = 0.98):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.lr = lr
        self.gate_at = gate_at
        self.hazard_decay = hazard_decay
        self.w = [-3.0, 2.5, 2.5, 2.0, 1.0, 1.0, 1.0]
        self.hazard = 0.0
        self.updates = 0
        self.gated = 0
        self._g_risk = self.metrics.gauge("sched.miss_risk")
        self._g_hazard = self.metrics.gauge("sched.miss_hazard")

    def features(self, *, queue_deadlined: int, batch: int,
                 free_frac: float, prefill_debt: int, debt_cap: int,
                 live_frac: float, arrival_ewma: float,
                 tpot_slowdown: float = 0.0) -> List[float]:
        b = max(1, batch)
        return [1.0,
                min(1.0, queue_deadlined / (2.0 * b)),
                min(1.0, 2.0 * arrival_ewma / b),
                min(1.0, max(0.0, 1.0 - free_frac)),
                min(1.0, prefill_debt / max(1, debt_cap)),
                min(1.0, max(0.0, live_frac)),
                max(-0.25, min(0.25, tpot_slowdown))]

    def risk(self, x: List[float]) -> float:
        z = sum(wi * xi for wi, xi in zip(self.w, x))
        return 1.0 / (1.0 + math.exp(-max(-30.0, min(30.0, z))))

    def consult(self, x: List[float]) -> float:
        """Per-cycle entry point: score ``x``, fold into the peak-hold
        hazard, publish both gauges, return the instantaneous risk."""
        r = self.risk(x)
        self.hazard = max(self.hazard * self.hazard_decay, r)
        self._g_risk.set(r)
        self._g_hazard.set(self.hazard)
        return r

    def spec_budget(self, batch: int) -> int:
        """How many NEW speculative (no-deadline) admissions this cycle
        may make — the predictor's batch-resize lever. Full batch below
        the gate, one row in the warning band, zero when the (peak-held)
        hazard says an overload is in progress or imminent."""
        h = max(self.hazard, 0.0)
        if h < self.gate_at:
            return batch
        if h < (1.0 + self.gate_at) / 2.0:
            return 1
        return 0

    def observe(self, x: List[float], missed: bool) -> None:
        """One SGD step on a retired deadlined request's admission-time
        features (label 1 = it missed its deadline)."""
        p = self.risk(x)
        g = (1.0 if missed else 0.0) - p
        self.w = [wi + self.lr * g * xi for wi, xi in zip(self.w, x)]
        self.updates += 1
