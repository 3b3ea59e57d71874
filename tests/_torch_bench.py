"""Shared helpers for the serving benches' parity tests: the reference
bench's own weights converted to the port, servers that record every
run's tokens in either package, and both packages' result paths pointed
at a scratch directory."""
from __future__ import annotations

import contextlib
import json
import re
from pathlib import Path

import jax
import pytest

from _torch_parity import numpy_tree, torch_model

from benchmarks import common as jcommon
from benchmarks import paged_serve as jps
from benchmarks import traffic as jtraffic
from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models.transformer import init_model as jax_init_model
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import paged_serve as tps
from repro_torch.benchmarks import traffic as ttraffic
from repro_torch.benchmarks.paged_serve import host_counters
from repro_torch.configs.registry import get_smoke_config

ROOT = Path(__file__).resolve().parents[1]
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)


def reference_params():
    """(config, params): the reference's qwen2-72b smoke config and the
    weights its benches draw (``init_model(PRNGKey(0), cfg)``)."""
    cfg = jax_smoke_config("qwen2-72b")
    return cfg, jax_init_model(jax.random.PRNGKey(0), cfg)


def reference_model():
    """(config, model): the port's smoke config with those weights."""
    cfg = get_smoke_config("qwen2-72b")
    return cfg, torch_model(numpy_tree(reference_params()[1]), cfg)


def _recording(cls, log):
    class Recording(cls):
        def run(self, requests, **kw):
            out = super().run(requests, **kw)
            log.append([list(r.out) for r in requests])
            return out
    return Recording


@contextlib.contextmanager
def scratch_results(tmp: Path):
    """Both packages' results (and the reference's trajectory) under
    ``tmp``; yields (reference runs, port runs): each a list of every
    served run's token lists, in order."""
    jlog, tlog = [], []
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jcommon, jps, jtraffic):
            mp.setattr(mod, "RESULTS", str(tmp / "ref"))
        mp.setattr(jps, "BENCH_TRAJECTORY", str(tmp / "ref" / "traj.json"))
        mp.setattr(tcommon, "RESULTS", tmp / "port")
        for mod in (jps, jtraffic):
            mp.setattr(mod, "BatchedServer",
                       _recording(mod.BatchedServer, jlog))
        for mod in (tps, ttraffic):
            mp.setattr(mod, "BatchedServer",
                       _recording(mod.BatchedServer, tlog))
        yield jlog, tlog


# what a result holds that a run on another machine need not repeat: its
# times, rates, token agreements, file paths and the gauges' windows
_NOT_MEASURED_HERE = ("accuracy_gate", "trace_path", "metrics_jsonl",
                      "slo_gauges_on", "host_pinned_bytes")


def _is_timing(key: str) -> bool:
    return (re.search(r"_m?s(_|$)", key) is not None or "per_s" in key
            or key.startswith(("wall", "ttft", "tpot"))
            or "agreement" in key or key in _NOT_MEASURED_HERE)


def _filtered(obj):
    if isinstance(obj, dict):
        return {k: _filtered(v) for k, v in obj.items()
                if not _is_timing(str(k))}
    if isinstance(obj, list):
        return [_filtered(v) for v in obj]
    return obj


def comparable(res, workload, *, reference=False):
    """A result's fields that are not times, rates, agreements or paths;
    the reference's kernel row renamed to the port's, the port's own
    ``host_pinned_bytes`` (pinned transfer buffers) left out. Raises if
    the filter drops one of the workload's host counters."""
    res = _filtered(res)
    if reference:
        text = json.dumps(res).replace("paged-int8-pallas",
                                       "paged-int8-kernel")
        res = json.loads(text.replace('"pallas"', '"kernel"'))
    host_counters(workload, res)
    return res


def flat_tokens(runs):
    return [out for run in runs for out in run]


class FakeClock:
    """Stands in for the ``time`` module a telemetry module sees (as
    ``test_torch_tier_serve.py``'s): each ``perf_counter`` call advances
    a fixed step, so the predictor's wall-clock feature counts the
    monitor's own calls and not the machine's load."""

    def __init__(self, step: float = 1e-3):
        self.now, self.step = 0.0, step

    def perf_counter(self) -> float:
        self.now += self.step
        return self.now
