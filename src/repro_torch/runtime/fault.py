"""Fault tolerance: restart supervisor + straggler monitor.

At 1000+ nodes the MTBF of the job is minutes-to-hours; the design here is
the standard production loop:

  * every step runs under the supervisor; any exception (device loss,
    preemption, injected fault) triggers restore-from-latest-checkpoint and
    replay — the data pipeline is a pure function of the step (data.pipeline)
    so replay is exact;
  * an async CheckpointManager bounds lost work to ``interval`` steps;
  * a StragglerMonitor tracks per-step wall time and flags outliers
    (> ``threshold`` x running median) — on real pods this feeds the
    scheduler's hot-spare swap; here it writes a structured log the tests
    assert on.

``FaultInjection`` is the test hook: raise it from a step callback to
simulate a node failure at a chosen step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np


class FaultInjection(RuntimeError):
    """Simulated node failure."""


@dataclasses.dataclass
class StragglerRecord:
    step: int
    seconds: float
    median: float
    flagged: bool


class StragglerMonitor:
    def __init__(self, threshold: float = 2.0, window: int = 50):
        self.threshold = threshold
        self.window = window
        self.records: List[StragglerRecord] = []
        self._times: List[float] = []

    def observe(self, step: int, seconds: float) -> StragglerRecord:
        self._times.append(seconds)
        tail = self._times[-self.window:]
        med = float(np.median(tail))
        flagged = len(tail) >= 5 and seconds > self.threshold * med
        rec = StragglerRecord(step, seconds, med, flagged)
        self.records.append(rec)
        return rec

    @property
    def flagged_steps(self):
        return [r.step for r in self.records if r.flagged]

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        t = np.asarray(self._times)
        return {"steps": len(t), "mean_s": float(t.mean()),
                "p50_s": float(np.percentile(t, 50)),
                "p99_s": float(np.percentile(t, 99)),
                "flagged": len(self.flagged_steps)}


class TrainSupervisor:
    """Runs ``step_fn(state, step) -> (state, metrics)`` with checkpoint/
    restart. ``state`` must be a pytree the CheckpointManager can save.

    restore_fn() -> (step, state) pulls the latest checkpoint; save_hook is
    the CheckpointManager.maybe_save bound method.
    """

    def __init__(self, *, step_fn: Callable, save_hook: Callable,
                 restore_fn: Callable, max_restarts: int = 3,
                 monitor: Optional[StragglerMonitor] = None,
                 on_restart: Optional[Callable] = None):
        self.step_fn = step_fn
        self.save_hook = save_hook
        self.restore_fn = restore_fn
        self.max_restarts = max_restarts
        self.monitor = monitor or StragglerMonitor()
        self.on_restart = on_restart
        self.restarts = 0

    def run(self, state, start_step: int, num_steps: int):
        """Returns (final_state, metrics_list). Restarts on failure."""
        step = start_step
        metrics_log = []
        while step < start_step + num_steps:
            try:
                t0 = time.time()
                state, metrics = self.step_fn(state, step)
                self.monitor.observe(step, time.time() - t0)
                metrics_log.append(metrics)
                step += 1
                self.save_hook(step, state)
            except FaultInjection as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                if self.on_restart:
                    self.on_restart(self.restarts, step)
                step, state = self.restore_fn()
        return state, metrics_log
