"""The port's train step and trainer CLI against the reference's
single-device functions: three ``make_train_step`` steps against the
reference's jitted step on the reference's batches (qwen2-72b, yi-34b
quantized, xlstm-350m at two chunks, hubert-xlarge from frame
embeddings, whose embedding table no loss term reads), the stacked-leaf
weight decay (the recurrent mixers' 1-D leaves included), the int8
moments' per-row scales under stacking, the trainable model's cast at
use, and the CLI (loss falls for every family, resume is exact for a
dense and a recurrent arch, quantized training with int8 moments and
the int8 gradient wire trains every block matrix, the example on xLSTM,
the refusals).

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
from test_torch_train import (_batch, _flat, _quants,  # noqa: E402
                              embeds_batch)

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.data.lm import LMDataConfig as JData  # noqa: E402
from repro.data.lm import lm_batch as jlm_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamW  # noqa: E402
from repro.optim.compress import \
    CompressionConfig as JCompress  # noqa: E402
from repro_torch.checkpoint.ckpt import restore_checkpoint  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.examples import \
    train_lm_mixed_precision as example  # noqa: E402
from repro_torch.launch.steps import (TrainHParams,  # noqa: E402
                                      init_train_state, make_train_step,
                                      reference_decay,
                                      train_state_tree)
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.transformer import (params_from_numpy,  # noqa
                                            reference_layout,
                                            reference_tree)
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: E402
                                     adamw_update)
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
    weights on the reference's batches, each package on its own state:
    per step, every loss term and the grad norm within rtol 1e-4. "fp32"
    is qwen2-72b-smoke; "quantized" is the example's arm (W10 / D12 /
    KV8, int8 moments, the int8 gradient wire with one scale per leaf of
    the reference's tree) on yi-34b-smoke, the reference's
    ``fake_quant`` replaced by ``fake_quant_ste`` (C5). (With one wire
    scale per unstacked parameter, C7, the grad norms parted by ~1e-3 at
    step 3, and this arm reloaded the port's state from the reference's
    before each step.)"""
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
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: t(v) for k, v in b.items()})
        assert set(m) == set(jm)
        for k in m:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                                abs=1e-6), k
    assert int(state["opt"]["step"]) == 3


@pytest.mark.parametrize("case", ["xlstm-350m", "hubert-xlarge-embeds"])
def test_make_train_step_tracks_the_reference_on_recurrent_and_embeds(
        case):
    """Three free-running steps of each package from the same weights:
    xlstm-350m-smoke on the reference's token batches at two chunks, and
    hubert-xlarge-smoke on ``make_batch``'s frame embeddings; per step
    every loss term and the grad norm within rtol 1e-4. hubert's
    embedding table is never read: the port's gradient there is None,
    the reference's zeros, and after the steps both tables are decayed
    alike and their moments are still zero."""
    arch = case.replace("-embeds", "")
    jcfg, tcfg, jparams, tree = perturbed_jax_params(arch, jit=True)
    jhp = jsteps.TrainHParams(lr=1e-3, adamw=JAdamW())
    thp = TrainHParams(lr=1e-3, adamw=AdamWConfig())
    jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, jhp)
    jstate["params"] = jparams
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    state = init_train_state(tcfg, thp, model=model)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jhp))
    step = make_train_step(tcfg, thp)
    if case.endswith("embeds"):
        batches = [embeds_batch(tcfg, B=4, S=32, seed=i) for i in range(3)]
    else:
        batches = _ref_batches(tcfg.vocab_size, 3, S=2 * tcfg.ssm_chunk)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: t(v) for k, v in b.items()})
        assert set(m) == set(jm)
        for k in m:
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4,
                                                abs=1e-6), k
    if case.endswith("embeds"):
        assert model.embed.grad is None
        np.testing.assert_allclose(model.embed.detach().numpy(),
                                   np.asarray(jstate["params"]["embed"]
                                              ["table"]), rtol=1e-6)
        assert not (model.embed.detach().numpy()
                    == tree["embed"]["table"]).any()
        for k in ("m", "v"):
            assert not state["opt"][k]["embed"].any()
            assert not np.asarray(jstate["opt"][k]["embed"]["table"]).any()


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


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-v0.1-52b"])
def test_reference_decay_holds_the_recurrent_leaves(arch):
    """The recurrent mixers' 1-D leaves (A_log, dt_bias, D_skip, conv_b,
    f_bias, the sLSTM's b, the mixers' norms) and the sLSTM's recurrent
    weight are stacked on the period axis in the reference, so its AdamW
    decays them, though the unstacked port sees rank 1: the decayed set is
    the reference tree's leaves of rank >= 2, exactly."""
    _, tcfg, _, tree = perturbed_jax_params(arch, jit=True)
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    dec = reference_decay(model, tcfg)
    ranks = _flat(jax.tree_util.tree_map(np.ndim, tree))
    names = dict(model.named_parameters())
    seen = set()
    for n, path, _ in reference_layout(model, tcfg):
        rank = ranks["".join(f"[{k!r}]" for k in path)]
        assert (n in dec) == (rank >= 2), (n, path, rank)
        if n.startswith("layers.") and names[n].dim() == 1:
            assert n in dec
            seen.add(path[-1] if path[-1] != "scale" else path[-2])
    want = {"A_log", "dt_bias", "D_skip", "conv_b", "norm"} \
        if arch.startswith("jamba") else {"f_bias", "b", "norm"}
    assert want <= seen
    assert "final_norm" not in dec


def test_int8_moments_scale_per_row_so_stacking_changes_nothing():
    """One int8-moment AdamW step of xlstm-350m-smoke on shared gradients:
    the port's per-parameter update and the reference's on its stacked
    tree give the same moment grids and per-row scales (a scale belongs
    to one row of the last dim, and a row never spans two periods),
    restacked; grids equal but for one step at a counted rounding tie."""
    _, tcfg, jparams, tree = perturbed_jax_params("xlstm-350m", jit=True)
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(3)
    grads = {n: t(rng.normal(0, 0.02, p.shape).astype(np.float32))
             for n, p in params.items()}
    cfg = AdamWConfig(quantize_moments=True)
    st = adamw_init(params, cfg)
    adamw_update(params, grads, st, 1e-3, cfg,
                 decay=reference_decay(model, tcfg))
    jcfg = JAdamW(quantize_moments=True)
    jg = jax.tree_util.tree_unflatten(  # the reference's tuples
        jax.tree_util.tree_structure(jparams),
        [jnp.asarray(x) for x in jax.tree_util.tree_leaves(reference_tree(
            {n: g.numpy() for n, g in grads.items()}, model, tcfg))])
    _, jst, _ = jadamw.adamw_update(jparams, jg, jadamw.adamw_init(
        jparams, jcfg), 1e-3, jcfg)
    flips = total = 0
    for k in ("m", "v"):
        mine = _flat(reference_tree({n: {a: b.numpy() for a, b in c.items()}
                                     for n, c in st[k].items()}, model,
                                    tcfg))
        want = _flat(jst[k])
        assert set(mine) == set(want)
        for key, w in want.items():
            assert mine[key].shape == w.shape, key
            if key.endswith("['scale']"):
                np.testing.assert_allclose(mine[key], w, rtol=1e-6,
                                           err_msg=key)
            else:
                d = np.abs(mine[key].astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1, key
                flips += int((d != 0).sum())
                total += d.size
    assert flips <= 1e-3 * total, (flips, total)


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
    (["--arch", "deepseek-7b", "--mesh", "single"], "item 13")])
def test_cli_refusals(args, match):
    with pytest.raises(NotImplementedError, match=match):
        train_mod.main(args + ["--smoke", "--device", "cpu", "--steps", "1"])


# the reference's own CLI test of training (tests/test_system.py)
FAMILY = ["--smoke", "--device", "cpu", "--steps", "30", "--batch-size",
          "4", "--seq-len", "64", "--log-every", "10", "--lr", "3e-3"]


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-v0.1-52b",
                                  "hubert-xlarge"])
def test_cli_trains_the_recurrent_and_encoder_archs(arch):
    """Each arch the trainer refused before (ROADMAP A12 part 2) trains
    from ``lm_batch`` tokens at the reference's own test arguments
    (two chunks of the recurrent smoke configs' 32), and its loss falls."""
    log = train_mod.main(["--arch", arch] + FAMILY)
    assert [r["step"] for r in log] == [10, 20, 30]
    assert np.isfinite(log[-1]["loss"])
    assert log[-1]["loss"] < log[0]["loss"]


def test_cli_resume_is_exact_for_xlstm(tmp_path):
    """20 straight steps of xlstm-350m-smoke == 10 steps + checkpoint +
    restore + 10 steps, bit for bit on the CPU (one thread)."""
    args = ["--arch", "xlstm-350m", "--smoke", "--device", "cpu",
            "--batch-size", "4", "--seq-len", "64", "--log-every", "5",
            "--lr", "3e-3"]
    log_a = train_mod.main(args + ["--steps", "20"])
    ck = str(tmp_path / "ck")
    train_mod.main(args + ["--steps", "10", "--ckpt-dir", ck,
                           "--ckpt-interval", "10"])
    log_b = train_mod.main(args + ["--steps", "20", "--ckpt-dir", ck,
                                   "--ckpt-interval", "100", "--resume"])
    assert [r["step"] for r in log_b] == [15, 20]
    assert log_a[-2:] == log_b


def test_cli_seq_len_off_the_chunk_raises_the_reference_words():
    with pytest.raises(ValueError, match="seq 48 not divisible by chunk 32"):
        train_mod.main(["--arch", "xlstm-350m", "--smoke", "--device",
                        "cpu", "--steps", "1", "--seq-len", "48"])


def test_example_trains_xlstm_in_both_arms(monkeypatch):
    """``examples/train_lm_mixed_precision.py --arch xlstm-350m`` (its
    docstring's model) on the CPU, cut to 4 steps: both arms finite, and
    in the quantized arm every mLSTM memory leaves its chunk on its
    layer's KV grid: the data format Q4.8 cut to the int8 container, Q4.4
    (the KV format inherits the data bits; ``--kv-bits 8`` alone would
    give Q2.6)."""
    from repro_torch.models import ssm
    seen = []
    real = ssm._maybe_fake_quant

    def spy(x, quant):
        out = real(x, quant)
        if quant is not None:
            seen.append((quant, out.detach()))
        return out

    monkeypatch.setattr(ssm, "_maybe_fake_quant", spy)
    base, quant = example.main(["--arch", "xlstm-350m", "--steps", "4",
                                "--device", "cpu"])
    assert np.isfinite(base[-1]["loss"]) and np.isfinite(quant[-1]["loss"])
    cfg = train_mod.get_smoke_config("xlstm-350m")
    q = train_mod.build_quant(cfg, weight_bits=10, data_bits=12, kv_bits=8,
                              policy_json="")
    assert {q.layer_state(li) for li in range(cfg.num_layers)} == {(4, 4)}
    assert seen and all(fmt == (4, 4) for fmt, _ in seen)
    for _, c in seen:
        assert torch.equal(torch.round(c * 16) / 16, c)
        assert -8.0 <= float(c.min()) and float(c.max()) <= 8.0 - 1 / 16
