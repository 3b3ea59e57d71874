"""The port's paper benches (Fig. 2, Fig. 3, Fig. 5 / Table 2), its report
section and its orchestrator, against the JAX package's, on a LeNet cache
the test writes.

The results directory of both packages is a temporary one. The port trains
LeNet for 60 steps (the recipe's 400 take minutes on one CPU thread) and
caches it through ``get_cnn``; the reference reads the same ``.npz``. Both
packages' eval sets are cut to the first 256 of the bench's 1024 images,
and the searches to a few steps, by patching the two packages alike.
"""
import functools
import json
import shutil

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (JAX on CPU, 1 thread)
import benchmarks.common as jcommon
import benchmarks.pareto_search as jpareto
import benchmarks.perlayer_sweep as jperlayer
import benchmarks.report as jreport
import benchmarks.uniform_sweep as juniform
from repro.data.synthetic import digits_dataset
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import pareto_search as tpareto
from repro_torch.benchmarks import perlayer_sweep as tperlayer
from repro_torch.benchmarks import report as treport
from repro_torch.benchmarks import run as trun
from repro_torch.benchmarks import uniform_sweep as tuniform
from repro_torch.examples import precision_search_lenet


def digits_256(n, seed=0):
    return digits_dataset(min(n, 256), seed=seed)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """A results directory holding the port's LeNet cache, and the same
    file where the reference looks for it."""
    d = tmp_path_factory.mktemp("results")
    mp = pytest.MonkeyPatch()
    mp.setattr(tcommon, "RESULTS", d)
    mp.setitem(tcommon._TRAIN_STEPS, "lenet", 60)
    try:
        spec, params, _, base = tcommon.get_cnn("lenet", device="cpu",
                                                verbose=False)
    finally:
        mp.undo()
    assert base > 0.3
    (d / "cnn").mkdir()
    shutil.copy(d / "torch_cnn" / "lenet.npz", d / "cnn" / "lenet.npz")
    return d


@pytest.fixture
def small(results, monkeypatch):
    """Both packages on ``results``, 256 eval images, short searches."""
    monkeypatch.setattr(tcommon, "RESULTS", results)
    monkeypatch.setattr(jcommon, "RESULTS", str(results))
    monkeypatch.setattr(jreport, "RESULTS", str(results))
    monkeypatch.setitem(tcommon._DATASETS, "lenet", digits_256)
    monkeypatch.setitem(jcommon._DATASETS, "lenet", (digits_256, 28))
    for mod in (tpareto, jpareto):
        monkeypatch.setattr(mod, "greedy_pareto_search", functools.partial(
            mod.greedy_pareto_search, max_steps=4))
        monkeypatch.setattr(mod, "sensitivity_search", functools.partial(
            mod.sensitivity_search, max_steps=6))
    return results


def as_json(d):
    """Keys as the JSON file holds them (ints become strings)."""
    return json.loads(json.dumps(d))


def test_cache_is_the_reference_s_layout(results):
    with np.load(results / "torch_cnn" / "lenet.npz") as npz:
        assert sorted(npz.files) == sorted(
            f"layer{i}_{k}" for i in range(1, 5) for k in "wb")
        assert npz["layer1_w"].shape == (5, 5, 1, 20)      # HWIO
        assert npz["layer3_w"].shape == (800, 500)


def test_uniform_sweep_matches_reference(small):
    got = tuniform.run(device="cpu", verbose=False, nets=["lenet"])
    ref = juniform.sweep_network("lenet", verbose=False)
    assert got["lenet"] == ref
    assert tcommon.load_json("uniform_sweep.json") == as_json(got)


def test_perlayer_sweep_matches_reference(small):
    got = tperlayer.run(device="cpu", verbose=False, nets=["lenet"])
    ref = jperlayer.sweep_network("lenet", verbose=False)
    assert got["lenet"] == ref
    assert tcommon.load_json("perlayer_sweep.json") == as_json(got)


def test_pareto_search_matches_reference(small):
    uniform = juniform.sweep_network("lenet", verbose=False)
    got = tpareto.run(device="cpu", verbose=False, nets=["lenet"])["lenet"]
    ref = jpareto.search_network("lenet", verbose=False,
                                 uniform={"lenet": uniform})
    for r in (got, ref):
        r.pop("wall_seconds")
    assert got == ref
    assert got["evaluations"] == 1 + 4 * 12     # the start, 4 steps of 12
    assert got.keys() == {"baseline_accuracy", "evaluations", "tolerances",
                          "sensitivity_search", "pareto"}


def test_report_renders_as_the_reference(small):
    """The port's section from its torch_* files is the reference's from
    the same records under its own names."""
    tuniform.run(device="cpu", verbose=False, nets=["lenet"])
    tpareto.run(device="cpu", verbose=False, nets=["lenet"])
    trun.main(["--only", "traffic"])
    for path in small.glob("torch_*.json"):
        shutil.copy(path, small / path.name[len("torch_"):])
    text = treport.repro_section()
    assert "| lenet | " in text and "paper Fig. 2" in text
    assert "paper Fig. 4" in text and "Table 2" in text
    assert text == jreport.repro_section()


def test_run_prints_cached_stages_and_raises_on_a_failure(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    monkeypatch.setattr(tcommon, "RESULTS", tmp_path)
    for name in ("uniform_sweep", "perlayer_sweep", "pareto_search",
                 "lm_precision"):
        tcommon.save_json(f"{name}.json", {"lenet": {}})
    ran = []
    monkeypatch.setattr(trun.kernel_bench, "run",
                        lambda device: ran.append(device))
    trun.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("[cached]") == 4 and ran == ["cpu"]
    assert tcommon.load_json("traffic.json").keys() == {"cnn", "lm"}

    def boom():
        raise ValueError("stage failed")
    monkeypatch.setattr(trun.traffic, "run_accounting", boom)
    with pytest.raises(ValueError, match="stage failed"):
        trun.main(["--only", "traffic"])
    with pytest.raises(SystemExit):
        trun.main(["--only", "roofline"])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    for call in (lambda: trun.main(["--only", "uniform_sweep"]),
                 lambda: tpareto.search_network("lenet", verbose=False),
                 lambda: precision_search_lenet.main([]),
                 lambda: tcommon.train_cnn("lenet", steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
