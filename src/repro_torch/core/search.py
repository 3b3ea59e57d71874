"""Per-layer precision assignment search (paper §2.5).

The paper's algorithm ("slowest gradient descent"):

  1. initialize all layers to a uniform precision with <0.1% error,
  2. form all delta configurations (each (layer, field) decremented by 1 bit),
  3. evaluate each, keep the delta with the best accuracy, iterate.

The trajectory of accepted configurations approximates the Pareto frontier in
(accuracy, traffic) space; for an error tolerance t, report the minimum-traffic
visited configuration with relative accuracy loss <= t (Table 2).

Beyond-paper: ``sensitivity_search`` replaces the O(L * bits * L) evaluation
count with a one-shot per-(layer, field) sensitivity profile followed by
largest-traffic-win-first greedy descent with accuracy backtracking — the same
frontier at a fraction of the evaluations; essential when one evaluation is a
full validation pass on a large model.

Host logic over the port's ``PrecisionPolicy`` and ``TrafficModel``, kept
move for move as the JAX package's ``core/search.py``, so one ``eval_fn``
gives both packages the same trajectory: the greedy step keeps the first
best move (strict ``>``), the sensitivity search takes the first of a
stable sort by ``(-sensitivity, -traffic saved)``.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .policy import FIELDS, PrecisionPolicy
from .traffic import TrafficModel

EvalFn = Callable[[PrecisionPolicy], float]  # policy -> accuracy in [0, 1]


@dataclasses.dataclass
class SearchPoint:
    policy: PrecisionPolicy
    accuracy: float
    traffic_ratio: float
    move: Optional[Tuple[int, str]]  # (layer idx, field) that produced it

    def as_dict(self):
        return {
            "accuracy": self.accuracy,
            "traffic_ratio": self.traffic_ratio,
            "move": list(self.move) if self.move else None,
            "policy": json.loads(self.policy.to_json()),
        }


@dataclasses.dataclass
class SearchResult:
    baseline_accuracy: float
    trajectory: List[SearchPoint]
    evaluations: int
    wall_seconds: float

    def pareto(self) -> List[SearchPoint]:
        """Non-dominated points: no other point has >= acc and <= traffic."""
        pts = sorted(self.trajectory, key=lambda p: p.traffic_ratio)
        out, best_acc = [], -np.inf
        for p in pts:
            if p.accuracy > best_acc:
                out.append(p)
                best_acc = p.accuracy
        return out

    def select(self, tolerance: float) -> Optional[SearchPoint]:
        """Min-traffic config with relative accuracy loss <= tolerance."""
        ok = [p for p in self.trajectory
              if p.accuracy >= self.baseline_accuracy * (1.0 - tolerance)]
        if not ok:
            return None
        return min(ok, key=lambda p: p.traffic_ratio)

    def table(self, tolerances=(0.01, 0.02, 0.05, 0.10)) -> str:
        rows = ["tol    TR      acc     bits-per-layer (W data)", "-" * 64]
        for t in tolerances:
            p = self.select(t)
            if p is None:
                rows.append(f"{t:<6.0%} (none reachable)")
                continue
            bits = "-".join(
                f"{lp.weight.total_bits if lp.weight else 32}."
                f"{lp.data.total_bits if lp.data else 32}"
                for lp in p.policy.layers)
            rows.append(f"{t:<6.0%} {p.traffic_ratio:<7.3f} {p.accuracy:<7.4f} {bits}")
        return "\n".join(rows)

    def as_dict(self):
        return {
            "baseline_accuracy": self.baseline_accuracy,
            "evaluations": self.evaluations,
            "wall_seconds": self.wall_seconds,
            "trajectory": [p.as_dict() for p in self.trajectory],
        }


def greedy_pareto_search(eval_fn: EvalFn,
                         traffic: TrafficModel,
                         init: PrecisionPolicy,
                         *,
                         baseline_accuracy: Optional[float] = None,
                         fields: Sequence[str] = FIELDS,
                         batch_size: int = 1,
                         mode: str = "batch",
                         max_steps: int = 200,
                         stop_rel_acc: float = 0.25,
                         verbose: bool = False) -> SearchResult:
    """The paper's algorithm, §2.5 steps 1-3.

    ``stop_rel_acc``: abandon the descent once accuracy falls this far below
    baseline (the paper notes curves "drop off sharply" past ~10%).
    """
    t0 = time.time()
    if baseline_accuracy is None:
        baseline_accuracy = eval_fn(PrecisionPolicy.fp32_baseline(init.names))
    evals = 0

    cur = init
    cur_acc = eval_fn(cur)
    evals += 1
    traj = [SearchPoint(cur, cur_acc,
                        traffic.traffic_ratio(cur, batch_size, mode), None)]

    for step in range(max_steps):
        moves = cur.candidate_moves(fields)
        if not moves:
            break
        best = None
        for (mv, pol) in moves:
            acc = eval_fn(pol)
            evals += 1
            if best is None or acc > best[1]:
                best = (mv, acc, pol)
        mv, acc, pol = best
        cur, cur_acc = pol, acc
        traj.append(SearchPoint(cur, cur_acc,
                                traffic.traffic_ratio(cur, batch_size, mode), mv))
        if verbose:
            print(f"[search] step={step} move={mv} acc={acc:.4f} "
                  f"tr={traj[-1].traffic_ratio:.3f}")
        if cur_acc < baseline_accuracy * (1.0 - stop_rel_acc):
            break
    return SearchResult(baseline_accuracy, traj, evals, time.time() - t0)


def sensitivity_profile(eval_fn: EvalFn, init: PrecisionPolicy,
                        *, fields: Sequence[str] = FIELDS,
                        probe_bits: int = 2) -> Dict[Tuple[int, str], float]:
    """Beyond-paper: one evaluation per (layer, field) at an aggressively
    reduced probe precision; the accuracy drop ranks sensitivity."""
    out = {}
    for i in range(len(init)):
        for f in fields:
            cur = init.layers[i].get_field(f)
            if cur is None:
                continue
            floor = 1 if f.endswith("_int") else 0
            probe = max(floor, cur - probe_bits)
            if probe == cur:
                continue
            out[(i, f)] = eval_fn(init.with_field(i, f, probe))
    return out


def sensitivity_search(eval_fn: EvalFn,
                       traffic: TrafficModel,
                       init: PrecisionPolicy,
                       *,
                       baseline_accuracy: Optional[float] = None,
                       fields: Sequence[str] = FIELDS,
                       batch_size: int = 1,
                       mode: str = "batch",
                       tolerance: float = 0.10,
                       max_steps: int = 400,
                       verbose: bool = False) -> SearchResult:
    """Beyond-paper search: profile once, then decrement least-sensitive /
    highest-traffic-win fields first, backtracking on tolerance violation.

    Evaluations: O(L) profile + O(accepted moves), vs the paper's
    O(L * total_bits_removed) — typically 5-20x fewer model evaluations.
    """
    t0 = time.time()
    if baseline_accuracy is None:
        baseline_accuracy = eval_fn(PrecisionPolicy.fp32_baseline(init.names))
    evals = 0

    prof = sensitivity_profile(eval_fn, init, fields=fields)
    evals += len(prof)

    cur = init
    cur_acc = eval_fn(cur)
    evals += 1
    traj = [SearchPoint(cur, cur_acc,
                        traffic.traffic_ratio(cur, batch_size, mode), None)]
    floor_acc = baseline_accuracy * (1.0 - tolerance)
    frozen = set()

    for step in range(max_steps):
        # rank candidate moves: prefer high sensitivity score (= small drop)
        # breaking ties by traffic saved
        cands = []
        for (mv, pol) in cur.candidate_moves(fields):
            if mv in frozen:
                continue
            sens = prof.get(mv, cur_acc)
            saved = (traj[-1].traffic_ratio
                     - traffic.traffic_ratio(pol, batch_size, mode))
            cands.append((sens, saved, mv, pol))
        if not cands:
            break
        cands.sort(key=lambda c: (-c[0], -c[1]))
        sens, saved, mv, pol = cands[0]
        acc = eval_fn(pol)
        evals += 1
        prof[mv] = acc  # refresh the profile so ranking adapts as we descend
        if acc >= floor_acc:
            cur, cur_acc = pol, acc
            traj.append(SearchPoint(cur, cur_acc,
                                    traffic.traffic_ratio(cur, batch_size, mode),
                                    mv))
            if verbose:
                print(f"[sens-search] step={step} move={mv} acc={acc:.4f} "
                      f"tr={traj[-1].traffic_ratio:.3f}")
        else:
            frozen.add(mv)  # this field is at its floor for this tolerance
    return SearchResult(baseline_accuracy, traj, evals, time.time() - t0)
