"""The LM precision bench's training half (``benchmarks/lm_precision.py``:
``train_small_lm``, ``lm_topk_accuracy``, ``run``), its report section and
``run.py`` stage, and ``examples/train_lm_mixed_precision.py``, against
the reference where the reference runs. The tests, not the package, feed
the port the reference's batches (its ``jax.random`` token stream) and
the reference's initial weights."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import lm_precision as jbench
from repro.configs.registry import get_smoke_config as jsmoke
from repro.data import lm as jlm
from repro.models.transformer import init_model as jinit
from repro_torch.benchmarks import common as tcommon
from repro_torch.benchmarks import lm_precision as bench
from repro_torch.benchmarks import report, run as run_mod
from repro_torch.configs.registry import get_smoke_config
from repro_torch.examples import train_lm_mixed_precision as example
from repro_torch.launch import train as train_mod
from repro_torch.models.transformer import params_from_numpy, train_loss

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


def _reference_batches(monkeypatch, module):
    """Make ``module.lm_batch`` (and ``lm_eval_stream``, where it has one)
    give the reference's batches as CPU tensors."""
    def batch(cfg, step):
        jcfg = jlm.LMDataConfig(**dataclasses.asdict(cfg))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            b = jlm.lm_batch(jcfg, step)
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}

    def stream(cfg, n, start_step=10 ** 6):
        for i in range(n):
            yield batch(cfg, start_step + i)

    monkeypatch.setattr(module, "lm_batch", batch)
    if hasattr(module, "lm_eval_stream"):
        monkeypatch.setattr(module, "lm_eval_stream", stream)
    return batch


def _bench_configs():
    cfg = dataclasses.replace(get_smoke_config("deepseek-7b"), num_layers=4,
                              dtype="float32")
    jcfg = dataclasses.replace(jsmoke("deepseek-7b"), num_layers=4,
                               dtype="float32")
    dcfg = bench.LMDataConfig(vocab_size=cfg.vocab_size, seq_len=96,
                              batch_size=12, num_mixtures=2, branching=8,
                              seed=11)
    return cfg, jcfg, dcfg


def _reference_init(jcfg, cfg):
    tree = jax.tree_util.tree_map(np.asarray, jax.jit(
        jinit, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    return tree


def test_train_small_lm_and_topk_track_the_reference(monkeypatch):
    """Six AdamW steps (weight decay 0.01, lr 1e-3) from the reference's
    initial weights on its batches: the trained models' held-out top-1
    agree within 2 tokens of 2 x 12 x 95 and their loss on a held-out
    batch within 1e-3 (Adam's sign trap keeps parameters from a tighter
    comparison); each package's top-1 of the same weights is equal."""
    cfg, jcfg, dcfg = _bench_configs()
    jdcfg = jlm.LMDataConfig(**dataclasses.asdict(dcfg))
    batch = _reference_batches(monkeypatch, bench)
    tree = _reference_init(jcfg, cfg)
    model = params_from_numpy(tree, cfg, device="cpu", trainable=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    assert bench.lm_topk_accuracy(model, cfg, dcfg) == pytest.approx(
        jbench.lm_topk_accuracy(jparams, jcfg, jdcfg), abs=1e-9)
    bench.train_small_lm(cfg, dcfg, steps=6, verbose=False, device="cpu",
                         model=model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jtrained = jbench.train_small_lm(jcfg, jdcfg, steps=6, verbose=False)
    n = 2 * dcfg.batch_size * (dcfg.seq_len - 1)
    got = bench.lm_topk_accuracy(model, cfg, dcfg)
    want = jbench.lm_topk_accuracy(jtrained, jcfg, jdcfg)
    assert abs(got - want) * n <= 2, (got, want)
    b = batch(dcfg, 10 ** 6 + 7)
    with torch.no_grad():
        tl = float(train_loss(model, b, cfg)[0])
    from repro.models.transformer import train_loss as jtrain_loss
    jl = float(jtrain_loss(jtrained, {k: jnp.asarray(v.numpy())
                                      for k, v in b.items()}, jcfg)[0])
    assert tl == pytest.approx(jl, rel=1e-3)
    assert all(p.grad is None for p in model.parameters())


def test_run_writes_the_search_and_the_report_renders_it(tmp_path,
                                                         monkeypatch):
    """``run`` (training cut to 3 steps by the test) on the reference's
    batches: its JSON has the reference's keys, the baseline is the
    trained model's own top-1, the search evaluated policies, and
    ``report.repro_section`` renders the LM part."""
    _reference_batches(monkeypatch, bench)
    with tcommon.results_in(tmp_path):
        out = bench.run(verbose=False, steps=3, device="cpu")
        saved = tcommon.load_json("lm_precision.json")
        text = report.repro_section()
    assert saved == json_roundtrip(out)
    assert set(out) >= {"arch", "baseline_topk1", "evaluations",
                        "tolerances"}
    assert out["arch"] == "deepseek-7b" and out["evaluations"] > 1
    assert 0.0 <= out["baseline_topk1"] <= 1.0
    assert "Beyond paper: same machinery on a transformer LM" in text
    assert f"{out['baseline_topk1']:.4f}" in text


def json_roundtrip(obj):
    import json
    return json.loads(json.dumps(obj))


def test_run_py_has_the_lm_precision_stage(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "run", lambda **kw: seen.append(kw))
    run_mod.main(["--only", "lm_precision", "--fast", "--device", "cpu"])
    assert seen == [{"steps": 120, "device": "cpu"}]


def test_example_trains_both_arms(monkeypatch, capsys):
    """The example's baseline and quantized arms (3 steps each, on the
    reference's batches): both finite, the comparison printed."""
    _reference_batches(monkeypatch, train_mod)
    base, quant = example.main(["--steps", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(base) == len(quant) == 1
    assert np.isfinite(base[-1]["loss"]) and np.isfinite(quant[-1]["loss"])
    assert "final loss: baseline=" in out
    assert "=== per-layer quantized" in out


def test_entry_points_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(verbose=False, steps=1)
