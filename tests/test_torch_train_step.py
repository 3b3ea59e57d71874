"""The port's train step and trainer CLI against the reference's
single-device functions: three ``make_train_step`` steps against the
reference's jitted step on the reference's batches, the stacked-leaf
weight decay, the trainable model's cast at use, and the CLI (loss
falls, resume is exact, quantized training with int8 moments and the
int8 gradient wire trains every block matrix, the refusals).

Multi-step runs are compared by loss and grad norm at the reference's own
resume tolerance (rtol 1e-4): Adam turns a sign into a step, so
parameters are not compared after a step."""
import dataclasses
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import perturbed_jax_params, t  # noqa: E402
from test_torch_train import _batch, _flat, _quants  # noqa: E402

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.data.lm import LMDataConfig as JData  # noqa: E402
from repro.data.lm import lm_batch as jlm_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamW  # noqa: E402
from repro.optim.compress import \
    CompressionConfig as JCompress  # noqa: E402
from repro_torch.checkpoint.ckpt import restore_checkpoint  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import (TrainHParams,  # noqa: E402
                                      init_train_state, load_train_state,
                                      make_train_step, reference_decay,
                                      train_state_tree)
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.compress import CompressionConfig  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _ref_batches(vocab, n, B=4, S=32):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d = JData(vocab_size=vocab, seq_len=S, batch_size=B, seed=1)
        return [{k: np.asarray(v) for k, v in jlm_batch(d, i).items()}
                for i in range(n)]


@pytest.mark.parametrize("arm", ["fp32", "quantized"])
def test_make_train_step_tracks_the_reference_jitted_step(arm, monkeypatch):
    """Three ``make_train_step`` steps of each package from the same
    weights on the reference's batches: per step, every loss term and the
    grad norm within rtol 1e-4. "fp32" runs free (each package on its own
    state). "quantized" is the example's arm (W10 / D12 / KV8, int8
    moments, the int8 gradient wire) on yi-34b-smoke, the reference's
    ``fake_quant`` replaced by ``fake_quant_ste`` (C5); there the port's
    state is reloaded from the reference's before each step
    (``load_train_state``), since gradients that differ by float ULPs
    round to different points of the wire's 255-level grid now and then,
    and Adam turns each such difference into a whole step (free-running,
    the grad norms part by ~1e-3 at step 3)."""
    arch = "qwen2-72b" if arm == "fp32" else "yi-34b"
    q = arm == "quantized"
    if q:
        monkeypatch.setattr(jtr, "fake_quant", jfp.fake_quant_ste)
    jcfg, tcfg, jparams, tree = perturbed_jax_params(arch, jit=True)
    bits = dict(weight_bits=10, data_bits=12, kv_bits=8) if q else {}
    tq, jq = _quants(tcfg, jcfg, **bits)
    jhp = jsteps.TrainHParams(lr=1e-3, adamw=JAdamW(quantize_moments=q),
                              grad_compress=JCompress() if q else None)
    thp = TrainHParams(lr=1e-3, adamw=AdamWConfig(quantize_moments=q),
                       grad_compress=CompressionConfig() if q else None)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, jhp)
    jstate["params"] = jparams
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    state = init_train_state(tcfg, thp, model=model)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jhp, quant=jq))
    step = make_train_step(tcfg, thp, quant=tq)
    for b in _ref_batches(tcfg.vocab_size, 3):
        if q:
            load_train_state(state, jax.tree_util.tree_map(
                lambda a: torch.from_numpy(np.array(a)), jstate), tcfg)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: t(v) for k, v in b.items()})
        assert set(m) == set(jm)
        for k in m:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                                abs=1e-6), k
    assert int(state["opt"]["step"]) == 3


def test_reference_decay_follows_the_stacked_layout():
    """The reference decays a layer's norm scales and QKV biases (stacked,
    they are 2-D) but not the final norm or the MTP module's 1-D
    leaves."""
    _, tcfg, _, tree = perturbed_jax_params("deepseek-v3-671b", jit=True)
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    dec = reference_decay(model, tcfg)
    names = dict(model.named_parameters())
    assert "layers.0.norm1" in dec and "layers.0.attn.q_norm" in dec
    assert "final_norm" not in dec and "mtp.norm" not in dec
    assert "mtp.block.norm1" not in dec and "mtp.proj" in dec
    assert all((n in dec) == (p.dim() >= 2 or n.startswith("layers."))
               for n, p in names.items())
    _, qcfg, _, qtree = perturbed_jax_params("qwen2-vl-2b", jit=True)
    qm = params_from_numpy(qtree, qcfg, device="cpu", trainable=True)
    assert "layers.0.attn.bq" in reference_decay(qm, qcfg)


def test_step_lr_argument_equals_a_step_built_at_that_rate():
    """One step at ``lr=x`` equals a step whose ``TrainHParams`` hold
    ``lr=x``, bit for bit; the same step serves every rate of a schedule
    and every model it is given."""
    _, tcfg, _, tree = perturbed_jax_params("qwen2-72b", jit=True)
    hp = TrainHParams(lr=1e-3, adamw=AdamWConfig(quantize_moments=True),
                      grad_compress=CompressionConfig())
    tok, lab = _batch(tcfg.vocab_size)
    batch = {"tokens": t(tok), "labels": t(lab)}
    shared = make_train_step(tcfg, hp)
    for lr in (2e-3, 5e-4):
        a = init_train_state(tcfg, hp, model=params_from_numpy(
            tree, tcfg, device="cpu", trainable=True))
        b = init_train_state(tcfg, hp, model=params_from_numpy(
            tree, tcfg, device="cpu", trainable=True))
        shared(a, batch, lr=lr)
        make_train_step(tcfg, dataclasses.replace(hp, lr=lr))(b, batch)
        pb = dict(b["params"].named_parameters())
        for n, p in a["params"].named_parameters():
            assert torch.equal(p, pb[n]), (lr, n)


def test_trainable_bf16_model_casts_at_use():
    """A trainable model of a bf16 config holds float32 masters and casts
    each weight at use: its forward equals the serving model's (weights
    cast once) bit for bit."""
    _, tcfg, _, tree = perturbed_jax_params("qwen2-72b", jit=True)
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    train = params_from_numpy(tree, cfg, device="cpu", trainable=True)
    serve = params_from_numpy(tree, cfg, device="cpu")
    assert train.layers[0].attn.wq.dtype == torch.float32
    assert train.layers[0].attn.wq.requires_grad
    assert train.layers[0].attn.cast_at_use == {
        n: torch.bfloat16 for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}
    assert not hasattr(train, "cast_at_use") or "final_norm" not in \
        train.cast_at_use
    assert serve.layers[0].attn.wq.dtype == torch.bfloat16
    tok, _ = _batch(cfg.vocab_size)
    with torch.no_grad():
        a = ttr.forward(train, t(tok), cfg)[1]
        b = ttr.forward(serve, t(tok), cfg)[1]
        # a serving model cast whole to float32 and run with a float32
        # config (as the card run's float32 gate does) casts nothing
        c = ttr.forward(serve.float(), t(tok), tcfg)[1]
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert c.dtype == torch.float32


# ---------------------------------------------------------------------------
# the CLI (the reference's tests/test_system.py arguments)
# ---------------------------------------------------------------------------
BASE = ["--arch", "deepseek-7b", "--smoke", "--device", "cpu",
        "--batch-size", "4", "--seq-len", "64", "--log-every", "5",
        "--lr", "1e-3"]


def test_cli_loss_decreases(tmp_path):
    out = tmp_path / "m.json"
    log = train_mod.main(BASE + ["--steps", "20", "--metrics-out",
                                 str(out)])
    assert [r["step"] for r in log] == [5, 10, 15, 20]
    assert log[-1]["loss"] < log[0]["loss"]
    assert np.isfinite(log[-1]["loss"])
    assert out.exists()


def test_cli_resume_is_exact(tmp_path):
    """20 straight steps == 10 steps + checkpoint + restore + 10 steps,
    bit for bit on the CPU (one thread)."""
    log_a = train_mod.main(BASE + ["--steps", "20"])
    ck = str(tmp_path / "ck")
    train_mod.main(BASE + ["--steps", "10", "--ckpt-dir", ck,
                           "--ckpt-interval", "10"])
    log_b = train_mod.main(BASE + ["--steps", "20", "--ckpt-dir", ck,
                                   "--ckpt-interval", "100", "--resume"])
    assert [r["step"] for r in log_b] == [15, 20]
    assert log_a[-2:] == log_b


def test_cli_quantized_training_trains_every_block_matrix(tmp_path):
    """The reference's quant + compression arguments (yi-34b-smoke, W10 /
    D12 / KV8, int8 moments, the int8 gradient wire): finite, loss within
    1.5x of the first log, and every block matrix's first moment nonzero
    in the final checkpoint (a gradient reached it: C5)."""
    ck = str(tmp_path / "ck")
    log = train_mod.main([
        "--arch", "yi-34b", "--smoke", "--device", "cpu", "--steps", "12",
        "--batch-size", "4", "--seq-len", "64", "--log-every", "6",
        "--lr", "1e-3", "--weight-bits", "10", "--data-bits", "12",
        "--kv-bits", "8", "--int8-moments", "--grad-compress",
        "--ckpt-dir", ck, "--ckpt-interval", "0"])
    assert np.isfinite(log[-1]["loss"])
    assert log[-1]["loss"] < log[0]["loss"] * 1.5
    cfg = train_mod.get_smoke_config("yi-34b")
    hp = TrainHParams(adamw=AdamWConfig(quantize_moments=True),
                      grad_compress=CompressionConfig())
    state = init_train_state(cfg, hp, device="cpu")
    step, tree, _ = restore_checkpoint(ck, train_state_tree(
        state, cfg, device="meta"))
    assert step == 12
    m = _flat(jax.tree_util.tree_map(lambda x: x.numpy(), tree["opt"]["m"]))
    qs = [k for k in m if "segments" in k and k.endswith("['q']")
          and m[k].ndim >= 3]
    assert len(qs) == 7 and all(m[k].any() for k in qs)


@pytest.mark.parametrize("args,match", [
    (["--arch", "deepseek-7b", "--mesh", "single"], "item 13"),
    (["--arch", "xlstm-350m"], "item 12"),
    (["--arch", "jamba-v0.1-52b"], "item 12"),
    (["--arch", "hubert-xlarge"], "item 12")])
def test_cli_refusals(args, match):
    with pytest.raises(NotImplementedError, match=match):
        train_mod.main(args + ["--smoke", "--device", "cpu", "--steps", "1"])
