"""Per-layer memory-traffic accounting (paper §2.4, Fig. 4, the TR column
of Table 2).

The paper counts each datum as transferred once per layer execution
(infinite on-chip reuse) and prices it at that layer's bit width:

    traffic_bits = sum_layers  accesses(layer, field) * bits(layer, field)

Two use cases (paper Fig. 4): ``single``, where weights are re-read per
image, and ``batch``, where weights are read once per layer per batch. TR
(traffic ratio) is reported against a 32-bit-everywhere baseline. For the
transformer archs the same model prices weight bytes, boundary activation
bytes and KV bytes per token (``quant.apply.transformer_traffic_model``).

The module also generates open-loop request-arrival traces for the
serving stack: seeded Poisson or bursty (two-state Markov-modulated
Poisson) arrivals, lognormal prompt and output lengths, and multi-tenant
mixes with per-tenant priority, deadline slack and shared system prompts.
``generate_trace(TraceConfig)`` draws everything from one
``np.random.default_rng(seed)`` in the reference's order, so a config
gives the same trace (and ``trace_fingerprint``) in both packages;
``benchmarks.traffic.to_requests`` turns it into serve requests.

Host arithmetic only.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Optional, Tuple

import numpy as np

from .policy import PrecisionPolicy

BASELINE_BITS = 32


@dataclasses.dataclass(frozen=True)
class LayerTraffic:
    """Access counts for one layer, in element units (not bytes)."""

    name: str
    weight_elems: int      # model parameters touched by the layer
    data_in_elems: int     # activations read (per image / per sequence)
    data_out_elems: int    # activations written

    @property
    def data_elems(self) -> int:
        return self.data_in_elems + self.data_out_elems


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    layers: tuple  # tuple[LayerTraffic]

    @property
    def names(self):
        return tuple(lt.name for lt in self.layers)

    def accesses(self, batch_size: int = 1, mode: str = "batch"):
        """(weight accesses, data accesses) summed over layers."""
        w = sum(lt.weight_elems for lt in self.layers)
        d = sum(lt.data_elems for lt in self.layers) * batch_size
        if mode == "single":
            w = w * batch_size  # weights re-read for every image
        elif mode != "batch":
            raise ValueError(mode)
        return w, d

    def traffic_bits(self, policy: PrecisionPolicy, batch_size: int = 1,
                     mode: str = "batch") -> float:
        if policy.names != self.names:
            raise ValueError("policy/traffic layer mismatch")
        total = 0.0
        for lt, lp in zip(self.layers, policy.layers):
            wbits = lp.weight.total_bits if lp.weight else BASELINE_BITS
            dbits = lp.data.total_bits if lp.data else BASELINE_BITS
            w = lt.weight_elems * (batch_size if mode == "single" else 1)
            total += w * wbits + lt.data_elems * batch_size * dbits
        return total

    def baseline_bits(self, batch_size: int = 1,
                      mode: str = "batch") -> float:
        w, d = self.accesses(batch_size, mode)
        return (w + d) * BASELINE_BITS

    def traffic_ratio(self, policy: PrecisionPolicy, batch_size: int = 1,
                      mode: str = "batch") -> float:
        """TR: priced traffic / 32-bit baseline (paper Table 2)."""
        return (self.traffic_bits(policy, batch_size, mode)
                / self.baseline_bits(batch_size, mode))

    def footprint_bytes(self, policy: PrecisionPolicy) -> float:
        """Static storage: weights once + one live copy of boundary data."""
        total = 0.0
        for lt, lp in zip(self.layers, policy.layers):
            wbits = lp.weight.total_bits if lp.weight else BASELINE_BITS
            dbits = lp.data.total_bits if lp.data else BASELINE_BITS
            total += (lt.weight_elems * wbits
                      + lt.data_out_elems * dbits) / 8.0
        return total


# ---------------------------------------------------------------------------
# Open-loop arrival-trace generation (serving traffic)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant class in a traffic mix.

    Lengths are lognormal (heavy-tailed): ``prompt_mean``/``max_new_mean``
    are the distribution MEANS in tokens (the underlying mu is derived),
    clipped to ``[1, *_cap]``. ``deadline_slack`` prices the SLO on the
    decode-step clock: an arrival at step t with n output tokens gets
    ``deadline_step = t + n + slack`` (slack = queueing budget; ``None``
    = no deadline, i.e. throughput/batch traffic that counts toward
    goodput whenever it finishes). ``shared_prefix_len > 0`` draws one of
    ``prefix_pool`` per-tenant system prompts (Zipf-weighted so pool entry
    0 is hottest) and prepends it — the knob that exercises the
    shared-prefix cache and host-tier promotions under a trace.
    """

    name: str
    weight: float = 1.0
    priority: int = 0
    deadline_slack: Optional[int] = None
    prompt_mean: float = 12.0
    prompt_sigma: float = 0.6
    prompt_cap: int = 48
    max_new_mean: float = 8.0
    max_new_sigma: float = 0.5
    max_new_cap: int = 32
    shared_prefix_len: int = 0
    prefix_pool: int = 1
    zipf_a: float = 1.5


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Seeded open-loop arrival process over a horizon of decode steps.

    ``process="poisson"`` draws ``Poisson(rate)`` arrivals per step.
    ``process="bursty"`` is a 2-state MMPP: a Markov chain flips between
    a quiet state (``rate``) and a burst state (``burst_rate``) with
    per-step entry/exit probabilities — arrivals cluster, which is what
    saturates an SLO scheduler (mean offered load can be modest while
    the instantaneous burst load is >> sustainable throughput).
    """

    seed: int = 0
    horizon: int = 64
    rate: float = 0.25
    process: str = "poisson"
    burst_rate: float = 1.0
    p_enter_burst: float = 0.05
    p_exit_burst: float = 0.25
    vocab_size: int = 1000
    tenants: Tuple[TenantSpec, ...] = (TenantSpec("default"),)


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One generated arrival — plain data, convertible to a serve Request."""

    rid: int
    tenant: str
    arrive_step: int
    prompt: np.ndarray          # int32 tokens (shared prefix + fresh tail)
    max_new: int
    priority: int
    deadline_step: Optional[int]
    prefix_id: int              # the tenant's prefix pool index (-1: none)


@dataclasses.dataclass(frozen=True)
class Trace:
    config: TraceConfig
    requests: Tuple[TraceRequest, ...]
    burst_steps: Tuple[int, ...]     # steps the MMPP spent in the burst state

    @property
    def offered_rate(self) -> float:
        """Mean arrivals per decode step over the horizon."""
        return len(self.requests) / max(1, self.config.horizon)

    def burst_rate_observed(self) -> float:
        """Arrivals per step measured over burst-state steps only."""
        if not self.burst_steps:
            return self.offered_rate
        burst = set(self.burst_steps)
        n = sum(1 for r in self.requests if r.arrive_step in burst)
        return n / len(burst)

    def mean_max_new(self) -> float:
        if not self.requests:
            return 0.0
        return float(np.mean([r.max_new for r in self.requests]))

    def overload_ratio(self, batch_size: int) -> float:
        """Burst-state offered load vs sustainable throughput.

        Sustainable decode throughput is ``batch_size / mean_service``
        requests per step (each live row emits one token per step), so
        the ratio > 1 means the burst arrives faster than the server can
        possibly drain it — the regime where admission policy, not raw
        speed, decides goodput.
        """
        service = self.mean_max_new()
        if service <= 0:
            return 0.0
        return self.burst_rate_observed() * service / max(1, batch_size)


def _lognormal_len(rng: np.random.Generator, mean: float, sigma: float,
                   cap: int) -> int:
    # parameterize by the distribution mean: mu = ln(mean) - sigma^2/2
    mu = np.log(max(1.0, mean)) - 0.5 * sigma * sigma
    return int(np.clip(round(rng.lognormal(mu, sigma)), 1, max(1, cap)))


def _zipf_pick(rng: np.random.Generator, n: int, a: float) -> int:
    if n <= 1:
        return 0
    w = 1.0 / np.arange(1, n + 1) ** a
    return int(rng.choice(n, p=w / w.sum()))


def generate_trace(cfg: TraceConfig) -> Trace:
    """Deterministically expand a TraceConfig into arrival records.

    All randomness flows from one ``np.random.default_rng(cfg.seed)``
    in a fixed draw order, so equal configs yield identical traces
    across processes and platforms.
    """
    if cfg.process not in ("poisson", "bursty"):
        raise ValueError(f"unknown arrival process: {cfg.process!r}")
    if not cfg.tenants:
        raise ValueError("TraceConfig needs at least one tenant")
    rng = np.random.default_rng(cfg.seed)
    weights = np.asarray([t.weight for t in cfg.tenants], dtype=np.float64)
    if weights.sum() <= 0:
        raise ValueError("tenant weights must sum > 0")
    weights = weights / weights.sum()

    # per-(tenant, pool slot) shared prefixes, drawn up front so tenant
    # order — not arrival order — determines their token content
    prefixes = {}
    for t in cfg.tenants:
        if t.shared_prefix_len > 0:
            for p in range(max(1, t.prefix_pool)):
                prefixes[(t.name, p)] = rng.integers(
                    0, cfg.vocab_size, t.shared_prefix_len).astype(np.int32)

    requests = []
    burst_steps = []
    in_burst = False
    rid = 0
    for step in range(cfg.horizon):
        if cfg.process == "bursty":
            flip = rng.random()
            in_burst = ((not in_burst and flip < cfg.p_enter_burst)
                        or (in_burst and flip >= cfg.p_exit_burst))
            if in_burst:
                burst_steps.append(step)
        rate = cfg.burst_rate if in_burst else cfg.rate
        for _ in range(int(rng.poisson(rate))):
            t = cfg.tenants[int(rng.choice(len(cfg.tenants), p=weights))]
            n_prompt = _lognormal_len(rng, t.prompt_mean, t.prompt_sigma,
                                      t.prompt_cap)
            max_new = _lognormal_len(rng, t.max_new_mean, t.max_new_sigma,
                                     t.max_new_cap)
            prefix_id = -1
            parts = []
            if t.shared_prefix_len > 0:
                prefix_id = _zipf_pick(rng, max(1, t.prefix_pool), t.zipf_a)
                parts.append(prefixes[(t.name, prefix_id)])
            parts.append(rng.integers(0, cfg.vocab_size, n_prompt)
                         .astype(np.int32))
            deadline = (None if t.deadline_slack is None
                        else step + max_new + t.deadline_slack)
            requests.append(TraceRequest(
                rid=rid, tenant=t.name, arrive_step=step,
                prompt=np.concatenate(parts), max_new=max_new,
                priority=t.priority, deadline_step=deadline,
                prefix_id=prefix_id))
            rid += 1
    return Trace(config=cfg, requests=tuple(requests),
                 burst_steps=tuple(burst_steps))


def trace_fingerprint(trace: Trace) -> str:
    """sha256 over the full arrival/length/tenant/token stream."""
    h = hashlib.sha256()
    for r in trace.requests:
        h.update(f"{r.rid}|{r.tenant}|{r.arrive_step}|{r.max_new}|"
                 f"{r.priority}|{r.deadline_step}|{r.prefix_id}|".encode())
        h.update(np.ascontiguousarray(r.prompt, dtype=np.int32).tobytes())
    return h.hexdigest()
