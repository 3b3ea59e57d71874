"""Port parity, serving telemetry (``--metrics on``): the port's tracer
records the reference's events for the same served trace (all but the
wall-clock ``ts`` and ``dur``), its ``request_stats`` agree on every
step-clock field, ``slo_summary`` handles the edge cases as the
reference's does, the JSONL snapshot stream and ``kv_inventory`` read the
registry, metrics on and off give identical tokens, and the CLI writes a
loadable Chrome trace."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import perturbed_jax_params, torch_model  # noqa: E402

from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro.runtime import telemetry as jtel  # noqa: E402
from repro_torch.core.paged_kv import caches_kv_bytes  # noqa: E402
from repro_torch.launch.serve import BatchedServer, Request  # noqa: E402
from repro_torch.runtime import telemetry as ttel  # noqa: E402

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
_WALL = ("ttft_s", "tpot_s")


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg, jparams, tree = perturbed_jax_params("qwen2-72b", seed=2)
    return jcfg, tcfg, jparams, torch_model(tree, tcfg)


def _trace(cls, vocab):
    """A shared system prompt, arrivals spread over the decode clock, a
    deadline, and more requests than slots (defers)."""
    rng = np.random.default_rng(4)
    sys_p = rng.integers(0, vocab, 10).astype(np.int32)
    reqs = []
    for i in range(6):
        p = np.concatenate([sys_p, rng.integers(0, vocab, 1 + 2 * i)
                            .astype(np.int32)])
        r = cls(i, p, 3 + i % 3)
        r.arrive_step = 2 * (i // 2)
        r.deadline_step = 12 if i == 3 else None
        reqs.append(r)
    return reqs


def _events(tracer):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in tracer.events]


@pytest.mark.parametrize("fused", ["off", "on"])
def test_tracer_events_match_reference(models, fused):
    jcfg, tcfg, jparams, model = models
    kw = dict(batch_size=2, max_len=40, page_size=8, kv_bits=8,
              prefill_bucket=8, prefix_cache="on", metrics="on",
              num_pages=6, fused=fused)
    jsrv = JServer(jcfg, jparams, **kw)
    jsrv.run(_trace(JRequest, jcfg.vocab_size))
    tsrv = BatchedServer(tcfg, model, device=CPU, **kw)
    tsrv.run(_trace(Request, tcfg.vocab_size))
    assert _events(tsrv.tracer) == _events(jsrv.tracer)
    names = {e["name"] for e in tsrv.tracer.events if e["ph"] == "X"}
    assert {"admission", "prefill_chunk" if fused == "off" else
            "fused_round", "decode_span"} <= names
    assert any(e["name"] == "defer" for e in tsrv.tracer.events)
    ts, js = tsrv.tracer.request_stats(), jsrv.tracer.request_stats()
    assert [{k: v for k, v in s.items() if k not in _WALL} for s in ts] == \
        [{k: v for k, v in s.items() if k not in _WALL} for s in js]
    a, b = tsrv.tracer.slo_summary(), jsrv.tracer.slo_summary()
    assert {k: v for k, v in a.items() if not k.endswith("_s")} == \
        {k: v for k, v in b.items() if not k.endswith("_s")}
    assert all(a[k] is not None and a[k] >= 0 for k in a if k.endswith("_s"))
    for e in tsrv.tracer.events:
        assert e["ph"] == "M" or e["ts"] >= 0


def test_slo_summary_zero_requests():
    s = ttel.Tracer().slo_summary()
    assert s == jtel.Tracer().slo_summary()
    assert s["requests"] == 0 and s["goodput"] is None


def test_slo_summary_all_deferred():
    out = []
    for tel in (ttel, jtel):
        tr = tel.Tracer()
        for rid in range(3):
            tr.req_arrive(rid, step=0, deadline_step=10)
            tr.req_defer(rid, step=1)
            tr.req_defer(rid, step=2)
        out.append((tr.slo_summary(), tr.request_stats(), _events(tr)))
    assert out[0] == out[1]
    s = out[0][0]
    assert s["goodput"] == 0.0 and s["deadline_misses"] == 3
    assert all(st["defers"] == 2 for st in out[0][1])


def test_slo_summary_never_first_token():
    out = []
    for tel in (ttel, jtel):
        tr = tel.Tracer()
        tr.req_arrive(0, step=0)
        tr.req_admit(0, step=0)
        tr.req_finish(0, step=3, tokens=0)
        tr.req_arrive(1, step=0)
        tr.req_admit(1, step=0)
        tr.req_first_token(1)
        tr.req_finish(1, step=4, tokens=5)
        tr.req_reject(2, step=5, reason="x")
        stats = tr.request_stats()
        assert stats[0]["ttft_s"] is None and stats[0]["tpot_s"] is None
        assert stats[1]["ttft_s"] is not None
        s = tr.slo_summary()
        assert s["ttft_p50_s"] == stats[1]["ttft_s"]
        out.append(([{k: v for k, v in st.items() if k not in _WALL}
                     for st in stats], _events(tr),
                    {k: v for k, v in s.items() if not k.endswith("_s")}))
    assert out[0] == out[1]
    assert out[0][2]["goodput"] == 1.0


def test_make_tracer_and_null_surface(tmp_path):
    assert isinstance(ttel.make_tracer("on"), ttel.Tracer)
    null = ttel.make_tracer("off")
    assert isinstance(null, ttel.NullTracer) and not null.enabled
    with pytest.raises(ValueError, match="metrics"):
        ttel.make_tracer("maybe")
    with null.span("x"):
        with null.req_span(0, "y"):
            null.req_arrive(0, 0)
            null.instant("z")
            null.req_finish(0, 1, 1)
    assert null.request_stats() == [] and null.slo_summary() == {}
    assert null.chrome_trace()["traceEvents"] == []
    path = tmp_path / "t.json"
    assert null.export_chrome(str(path)) is None and not path.exists()


def test_snapshotter_jsonl_stream(tmp_path):
    out = []
    for tel in (ttel, jtel):
        reg = tel.MetricsRegistry()
        reg.counter("c").inc(4)
        reg.register_gauge("g", lambda: 7)
        reg.histogram("h").observe(2.0)
        path = str(tmp_path / f"{tel.__name__}.jsonl")
        snap = tel.MetricsSnapshotter(reg, path, every=10)
        assert [snap.maybe_emit(c) for c in (0, 5)] == [True, False]
        reg.counter("c").inc(1)
        reg.histogram("h").observe(4.0)
        assert snap.maybe_emit(10) is True
        lines = [json.loads(ln) for ln in open(path)]
        assert all(ln.pop("elapsed_s") >= 0 for ln in lines)
        out.append(lines)
        with pytest.raises(ValueError, match="interval"):
            tel.MetricsSnapshotter(reg, path, every=0)
    assert out[0] == out[1]
    assert [ln["counters"]["c"] for ln in out[0]] == [4, 5]


def test_server_snapshot_stream(models, tmp_path):
    _, tcfg, _, model = models
    path = str(tmp_path / "m.jsonl")
    srv = BatchedServer(tcfg, model, batch_size=2, max_len=40, page_size=8,
                        kv_bits=8, prefix_cache="on", metrics="on",
                        snapshot_out=path, snapshot_every=2, device=CPU)
    srv.run(_trace(Request, tcfg.vocab_size))
    lines = [json.loads(ln) for ln in open(path)]
    assert len(lines) >= 2
    last = lines[-1]
    assert last["counters"]["serve.decode_steps"] <= srv.decode_steps
    assert "prefix.hits" in last["counters"]
    assert "kv.device_bytes" in last["gauges"]


@pytest.mark.parametrize("kv_bits,fused", [(0, "off"), (8, "off"),
                                           (4, "off"), (8, "on")])
def test_metrics_modes_are_token_neutral(models, kv_bits, fused):
    _, tcfg, _, model = models
    outs = {}
    for m in ("off", "on"):
        srv = BatchedServer(tcfg, model, batch_size=2, max_len=40,
                            page_size=8, kv_bits=kv_bits, prefix_cache="on",
                            metrics=m, fused=fused, device=CPU)
        outs[m] = [r.out for r in srv.run(_trace(Request, tcfg.vocab_size))]
        if fused == "on":
            assert srv.metrics.value("serve.program_launches") == \
                srv.metrics.value("serve.cycles")
    assert outs["off"] == outs["on"]


def test_kv_inventory_reconciles_with_gauges(models):
    _, tcfg, _, model = models
    srv = BatchedServer(tcfg, model, batch_size=2, max_len=32, kv_bits=8,
                        page_size=8, prefix_cache="on", metrics="on",
                        device=CPU)
    srv.run(_trace(Request, tcfg.vocab_size)[:3])
    inv = srv.kv_inventory()
    g = srv.metrics.gauge
    assert inv["device_bytes"] == g("kv.device_bytes").value
    assert inv["device_pages_free"] == g("kv.device_pages_free").value
    assert inv["device_pages_usable"] == g("kv.device_pages_usable").value
    assert inv["device_bytes"] == sum(caches_kv_bytes(srv.caches).values())
    assert inv["device_bytes"] == sum(inv["device_by_container"].values())
    assert inv["device_pages_free"] == srv.allocator.num_free
    assert inv["host_pages"] == inv["tier_pages"] == 0
    dense = BatchedServer(tcfg, model, batch_size=2, max_len=32, device=CPU)
    assert dense.kv_inventory()["device_bytes"] == 0


def test_cli_writes_a_chrome_trace(tmp_path):
    out = tmp_path / "trace.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen2-72b", "--smoke", "--device", "cpu", "--requests", "4",
         "--batch-size", "2", "--max-new", "3", "--max-len", "32",
         "--page-size", "8", "--kv-bits", "8", "--prefix-cache", "on",
         "--kv-scale", "page", "--metrics", "on", "--trace-out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "[serve] slo: goodput=1.000 (4/4 finished" in res.stdout
    trace = json.loads(out.read_text())
    evs = trace["traceEvents"]
    assert sum(e["name"] == "finish" for e in evs) == 4
    assert {e["ph"] for e in evs} == {"M", "X", "i"}
