"""The port's examples on the CPU (``python -m repro_torch.examples.<name>
--device cpu``): the quickstart's paper search on LeNet (its search cut
to 3 steps here; the whole search takes minutes on one thread), the
search -> ``--kv-profile`` -> serving loop, and the serving tour of
``serve_quantized_kv`` (the reference's, its replica section included);
each entry point raises without a card unless given ``--device cpu``."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.fixedpoint import fake_quant as jfake_quant  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro_torch.benchmarks import common as tcommon  # noqa: E402
from repro_torch.core.fixedpoint import fake_quant  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.examples import serve_policy_profile  # noqa: E402
from repro_torch.examples import serve_quantized_kv  # noqa: E402

CPU = ["--device", "cpu"]


def test_quickstart_runs_the_papers_search(monkeypatch, capsys):
    search = quickstart.greedy_pareto_search
    monkeypatch.setattr(quickstart, "greedy_pareto_search",
                        lambda *a, **kw: search(*a, **dict(kw, max_steps=3)))
    res = quickstart.main(CPU)
    out = capsys.readouterr().out
    assert "fake_quant Q(2,4): tensor([ 0.7500, -1.1875,  1.9375,  0.0000])" \
        in out
    assert "baseline top-1" in out and "tol" in out
    assert res.evaluations > 1 and len(res.trajectory) == 4
    assert res.trajectory[-1].traffic_ratio < res.trajectory[0].traffic_ratio


def test_quickstart_conversion_is_the_references():
    x = np.asarray([0.7311, -1.2, 3.9, 0.01], np.float32)
    got = fake_quant(torch.from_numpy(x), 2, 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfake_quant(x, 2, 4)))


def test_serve_policy_profile(tmp_path, monkeypatch):
    monkeypatch.setattr(tcommon, "RESULTS", tmp_path)
    res = serve_policy_profile.main(CPU)
    path = tmp_path / "torch_kv_policy_qwen2_72b_smoke.json"
    text = path.read_text()
    # the file --kv-profile loads, in the reference's format
    assert JPolicy.from_json(text).to_json() == text
    assert res["policy"].to_json() == text
    assert res["leaks"] == (0, 0)
    assert res["bytes_profile"] <= res["bytes_int8"]
    assert 0.0 <= res["agreement"] <= 1.0 and res["evaluations"] > 1
    assert len(json.loads(text)["layers"]) == 4


def test_serve_quantized_kv(capsys):
    out = serve_quantized_kv.main(CPU)
    text = capsys.readouterr().out
    fp_b, q8_b, p4_b = out["footprint"]
    assert q8_b < fp_b and p4_b < q8_b
    separate, fused, cycles = out["fused"]
    assert fused == cycles and fused < separate
    preempts, resumes, snapped, restored = out["tiered"]
    assert preempts == resumes >= 1 and snapped == restored > 0
    assert out["adapt"]["requants"] >= 1
    slo, delta = out["telemetry"]
    assert slo["finished"] == slo["requests"] == 3
    assert delta["serve.decode_steps"] == 2
    assert "cannot back request 99" in out["rejected"]
    assert out["served_behind"] == (True, 8)
    assert "multi-replica frontend" in text
    c = out["replica_counters"]
    assert (c["frontend.routed_replica0"] + c["frontend.routed_replica1"]
            == c["frontend.routed"] == out["traffic"][0])
    assert c["frontend.shared_prefix_pages"] >= 1
    assert out["replica_goodput"][2] >= out["replica_goodput"][1]


@pytest.mark.parametrize("example", [quickstart, serve_policy_profile,
                                     serve_quantized_kv])
def test_examples_default_to_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
