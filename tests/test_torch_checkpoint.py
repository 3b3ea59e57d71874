"""The port's checkpoints (``repro_torch.checkpoint.ckpt``) and fault
supervisor (``runtime.fault``): the reference's own cases, the quantized
containers byte for byte against the reference's, train states cross-
loaded both ways between the packages on qwen2-72b-smoke, xlstm-350m-smoke
and hubert-xlarge-smoke (trained from frame embeddings), a supervisor
restart of xlstm-350m-smoke bitwise equal to an uninterrupted run, and C6
(a bf16 leaf round-trips in the port; the reference's restore raises on
it)."""
import functools
import os
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _torch_parity import perturbed_jax_params  # noqa: E402
from test_torch_train import embeds_batch  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.core.policy import LayerPolicy as JLayer  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamW  # noqa: E402
from repro.optim.compress import \
    CompressionConfig as JCompress  # noqa: E402
from repro_torch.checkpoint.ckpt import (CheckpointManager,  # noqa: E402
                                         latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.data.lm import LMDataConfig, lm_batch  # noqa: E402
from repro_torch.data.pipeline import DataPipeline  # noqa: E402
from repro_torch.core.policy import LayerPolicy, PrecisionPolicy  # noqa
from repro_torch.launch.steps import (TrainHParams,  # noqa: E402
                                      init_train_state, load_train_state,
                                      make_train_step, train_state_tree)
from repro_torch.models.transformer import params_from_numpy  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.optim.compress import CompressionConfig  # noqa: E402
from repro_torch.runtime.fault import (FaultInjection,  # noqa: E402
                                       StragglerMonitor, TrainSupervisor)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"layer_000": torch.randn(8, 16, generator=g),
                       "norm": torch.ones(16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "m": torch.zeros(8, 16)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the reference's own cases (tests/test_checkpoint_fault.py), on the port
# ---------------------------------------------------------------------------
def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    st = _state()
    save_checkpoint(d, 42, st, extra={"foo": 1})
    assert latest_step(d) == 42
    step, restored, extra = restore_checkpoint(d, st)
    assert step == 42 and extra == {"foo": 1}
    for a, b in zip(_leaves(st), _leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_save_and_gc(tmp_path):
    d = str(tmp_path / "ckpt")
    threads = [save_checkpoint(d, s, _state(), async_=True, keep=2)
               for s in (1, 2, 3, 4)]
    for t in threads:
        t.join()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d))
    assert steps == [3, 4]


def _held_writer(monkeypatch):
    """Holds every async writer thread until the returned event is set, so
    a test can change the state while a save is in flight."""
    import repro_torch.checkpoint.ckpt as ckpt_mod
    go, real = threading.Event(), ckpt_mod._write

    def held(*a):
        assert go.wait(timeout=60)
        real(*a)

    monkeypatch.setattr(ckpt_mod, "_write", held)
    return go


@pytest.mark.parametrize("leaf", ["float32", "bfloat16", "numpy"])
def test_async_save_holds_the_state_of_its_call(tmp_path, monkeypatch,
                                                leaf):
    """An async save writes the state as it was when ``save_checkpoint``
    was called, although the caller updates host leaves in place while
    the writer runs (the train step does)."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn(8, 16, generator=g)
    if leaf == "bfloat16":
        w = w.to(torch.bfloat16)
    st = {"params": {"w": w.numpy() if leaf == "numpy" else w}}
    want = w.clone()
    go = _held_writer(monkeypatch)
    d = str(tmp_path / "ckpt")
    t = save_checkpoint(d, 1, st, async_=True)
    w.add_(1.0)                       # the next step, in place
    go.set()
    t.join()
    _, got, _ = restore_checkpoint(d, {"params": {"w": want}})
    assert torch.equal(got["params"]["w"].view(torch.int16) if
                       leaf == "bfloat16" else got["params"]["w"],
                       want.view(torch.int16) if leaf == "bfloat16"
                       else want)


def test_incomplete_checkpoint_is_skipped(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 10, _state())
    os.makedirs(os.path.join(d, "step_000000011"))
    assert latest_step(d) == 10


def test_quantized_checkpoint_roundtrip(tmp_path):
    d = str(tmp_path / "ckpt")
    st = _state()
    pol = PrecisionPolicy(("layer_000",),
                          (LayerPolicy(FixedPointFormat(3, 5), None),))
    save_checkpoint(d, 1, st, policy=pol)
    npz = np.load(os.path.join(d, "step_000000001", "arrays.npz"))
    assert npz["params::layer_000"].dtype == np.int8
    _, restored, _ = restore_checkpoint(d, st)
    np.testing.assert_allclose(restored["params"]["layer_000"].numpy(),
                               st["params"]["layer_000"].numpy(),
                               atol=2 ** -5)
    assert torch.equal(restored["params"]["norm"], st["params"]["norm"])


def test_supervisor_restarts_from_checkpoint(tmp_path):
    d = str(tmp_path / "ckpt")
    ckpt = CheckpointManager(d, interval=2)
    fail_at = {5: True, 9: True}
    executed = []

    def step_fn(state, step):
        if fail_at.pop(step, None):
            raise FaultInjection(f"node lost at step {step}")
        executed.append(step)
        return {"x": state["x"] + 1}, {"step": step}

    def save_hook(step, state):
        ckpt.maybe_save(step, state, extra={})

    def restore_fn():
        ckpt.wait()
        step, state, _ = ckpt.restore_latest(
            {"x": torch.tensor(0, dtype=torch.int32)})
        return step, state

    sup = TrainSupervisor(step_fn=step_fn, save_hook=save_hook,
                          restore_fn=restore_fn, max_restarts=5)
    state, metrics = sup.run({"x": torch.tensor(0, dtype=torch.int32)}, 0,
                             12)
    assert sup.restarts == 2
    assert int(state["x"]) == 12
    assert len(metrics) >= 12


def test_supervisor_gives_up_after_max_restarts():
    def step_fn(state, step):
        raise FaultInjection("always down")

    sup = TrainSupervisor(step_fn=step_fn, save_hook=lambda *a: None,
                          restore_fn=lambda: (0, {}), max_restarts=2)
    with pytest.raises(RuntimeError, match="exceeded"):
        sup.run({}, 0, 5)


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(threshold=2.0, window=50)
    for i in range(20):
        mon.observe(i, 0.1)
    rec = mon.observe(20, 0.5)
    assert rec.flagged
    assert mon.flagged_steps == [20]
    s = mon.summary()
    assert s["steps"] == 21 and s["flagged"] == 1


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fmt", [(3, 5), (2, 10), (6, 6)])
def test_quantized_containers_equal_the_reference(tmp_path, fmt):
    """For the same array and policy, the port writes the reference's
    container (int8 or int16) byte for byte, the same manifest entries,
    and each package restores the other's file to the same values."""
    arr = np.random.default_rng(4).normal(0, 2, (8, 16)).astype(np.float32)
    tp = PrecisionPolicy(("layer_000",),
                         (LayerPolicy(FixedPointFormat(*fmt), None),))
    jp = JPolicy(("layer_000",), (JLayer(JFormat(*fmt), None),))
    dt, dj = str(tmp_path / "t"), str(tmp_path / "j")
    save_checkpoint(dt, 1, {"params": {"layer_000": torch.from_numpy(arr)}},
                    policy=tp)
    jckpt.save_checkpoint(dj, 1, {"params": {"layer_000": jnp.asarray(arr)}},
                          policy=jp)
    a = np.load(os.path.join(dt, "step_000000001", "arrays.npz"))
    b = np.load(os.path.join(dj, "step_000000001", "arrays.npz"))
    key = "params::layer_000"
    assert a[key].dtype == b[key].dtype
    np.testing.assert_array_equal(a[key], b[key])
    man = [jckpt.json.load(open(os.path.join(d, "step_000000001",
                                             "manifest.json")))
           for d in (dt, dj)]
    assert man[0]["quant"] == man[1]["quant"]
    _, got, _ = restore_checkpoint(dj, {"params": {"layer_000":
                                                   torch.zeros(8, 16)}})
    _, want, _ = jckpt.restore_checkpoint(
        dt, {"params": {"layer_000": jax.ShapeDtypeStruct((8, 16),
                                                          jnp.float32)}})
    np.testing.assert_array_equal(got["params"]["layer_000"].numpy(),
                                  np.asarray(want["params"]["layer_000"]))


@functools.lru_cache(maxsize=None)
def _ref_states(arch, embeds=False):
    """An arch's smoke train states after one reference train step (so
    moments and residuals are not zero), from tokens or (``embeds``) from
    ``make_batch``'s stub-frontend batch: fp32 moments, and int8 moments
    with the int8 gradient wire."""
    jcfg, tcfg, jparams, tree = perturbed_jax_params(arch, jit=True)
    if embeds:
        batch = {k: jnp.asarray(v) for k, v in
                 embeds_batch(tcfg, B=2, S=12).items()}
    else:
        rng = np.random.default_rng(0)
        tok = rng.integers(0, tcfg.vocab_size, (2, 12)).astype(np.int32)
        batch = {"tokens": jnp.asarray(tok),
                 "labels": jnp.asarray(np.concatenate(
                     [tok[:, 1:], np.full((2, 1), -100, np.int32)], 1))}
    out = {}
    for arm, q in (("fp32", False), ("int8", True)):
        jhp = jsteps.TrainHParams(
            lr=1e-3, adamw=JAdamW(quantize_moments=q),
            grad_compress=JCompress() if q else None)
        thp = TrainHParams(lr=1e-3, adamw=AdamWConfig(quantize_moments=q),
                           grad_compress=CompressionConfig() if q else None)
        jstate = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, jhp)
        jstate["params"] = jparams
        jstate, _ = jax.jit(jsteps.make_train_step(jcfg, jhp))(jstate, batch)
        out[arm] = (jcfg, tcfg, jstate, thp, tree)
    return out


@pytest.fixture(scope="module")
def qwen_states():
    """qwen2-72b-smoke's :func:`_ref_states`."""
    return _ref_states("qwen2-72b")


def _port_state(tcfg, thp, tree):
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    return init_train_state(tcfg, thp, model=model)


def _flat_np(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arm", ["fp32", "int8"])
def test_train_state_cross_loads_both_ways(tmp_path, qwen_states, arm):
    """The reference's train state saved by the reference restores into
    the port's state leaf for leaf (the layers unstacked); the port's
    saved state restores in the reference to the same tree, under the
    same keys."""
    _cross_load(tmp_path, *qwen_states[arm])


@pytest.mark.parametrize("arm", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ["xlstm-350m", "hubert-xlarge"])
def test_recurrent_and_encoder_train_states_cross_load_both_ways(
        tmp_path, arch, arm):
    """As the qwen2-72b case, for a recurrent train state (xlstm: mLSTM
    and sLSTM leaves stacked over two periods) and an encoder's trained
    from frame embeddings (hubert: the unread embedding table decayed,
    its moments zero)."""
    _cross_load(tmp_path, *_ref_states(arch, embeds=arch == "hubert-xlarge")
                [arm])


def _cross_load(tmp_path, jcfg, tcfg, jstate, thp, tree):
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save_checkpoint(dj, 5, jstate, extra={"data": {"step": 5}})
    state = _port_state(tcfg, thp, tree)
    template = train_state_tree(state, tcfg, device="meta")
    step, got, extra = restore_checkpoint(dj, template)
    assert step == 5 and extra == {"data": {"step": 5}}
    load_train_state(state, got, tcfg)
    mine = _flat_np(jax.tree_util.tree_map(
        lambda t: t.numpy(), train_state_tree(state, tcfg)))
    want = _flat_np(jstate)
    assert set(mine) == set(want)
    for k, v in want.items():
        assert mine[k].dtype == v.dtype, k
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    save_checkpoint(dt, 6, train_state_tree(state, tcfg))
    keys_t = json_keys(dt, 6)
    assert keys_t == json_keys(dj, 5)
    _, back, _ = jckpt.restore_checkpoint(
        dt, jax.eval_shape(lambda: jstate))
    for k, v in _flat_np(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_supervisor_restart_of_xlstm_is_bitwise(tmp_path):
    """xlstm-350m-smoke (int8 moments, the int8 wire) trained 6 steps
    under ``TrainSupervisor`` with a checkpoint every 3 steps and a
    ``FaultInjection`` at step 4 (restored from step 3, the pipeline
    rewound to it): parameters, moments and residuals bit for bit those
    of 6 uninterrupted steps."""
    cfg = get_smoke_config("xlstm-350m")
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                        batch_size=4, seed=1)
    hp = TrainHParams(lr=3e-3, adamw=AdamWConfig(quantize_moments=True),
                      grad_compress=CompressionConfig())
    step_fn = make_train_step(cfg, hp)

    def fresh():
        return init_train_state(cfg, hp, seed=0, device="cpu")

    def flat(state):
        return _flat_np(jax.tree_util.tree_map(
            lambda t: t.numpy(), train_state_tree(state, cfg)))

    state = fresh()
    pipe = DataPipeline(lambda s: lm_batch(dcfg, s), device="cpu")
    for _ in range(6):
        state, _ = step_fn(state, next(pipe))
    want = flat(state)

    state = fresh()
    pipe = DataPipeline(lambda s: lm_batch(dcfg, s), device="cpu")
    ckpt = CheckpointManager(str(tmp_path / "ck"), interval=3)
    template = train_state_tree(state, cfg, device="meta")
    fail = {4}

    def one_step(st, step):
        if step in fail:
            fail.discard(step)
            raise FaultInjection(f"node lost at step {step}")
        return step_fn(st, next(pipe))

    def save_hook(step, st):
        ckpt.maybe_save(step, train_state_tree(st, cfg),
                        extra={"data": {"step": step}})

    def restore_fn():
        ckpt.wait()
        step, tree, extra = ckpt.restore_latest(template)
        load_train_state(state, tree, cfg)
        pipe.restore(extra["data"])
        return step, state

    sup = TrainSupervisor(step_fn=one_step, save_hook=save_hook,
                          restore_fn=restore_fn)
    state, _ = sup.run(state, 0, 6)
    ckpt.wait()
    assert sup.restarts == 1
    got = flat(state)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_manager_save_survives_the_next_train_step(tmp_path, monkeypatch,
                                                  qwen_states):
    """``CheckpointManager`` saves a train state on the CPU while the next
    ``make_train_step`` step updates its parameters, moments and residuals
    in place: the restored checkpoint is the state of the saved step."""
    _, tcfg, _, thp, tree = qwen_states["int8"]
    state = _port_state(tcfg, thp, tree)
    tok = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 12))
    batch = {"tokens": torch.from_numpy(tok.astype(np.int64)),
             "labels": torch.from_numpy(np.concatenate(
                 [tok[:, 1:], np.full((2, 1), -100)], 1).astype(np.int64))}
    step = make_train_step(tcfg, thp)
    step(state, batch)
    want = {k: np.array(v) for k, v in
            _flat_np(jax.tree_util.tree_map(
                lambda t: t.numpy(), train_state_tree(state, tcfg))).items()}
    go = _held_writer(monkeypatch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), interval=1)
    assert mgr.maybe_save(1, train_state_tree(state, tcfg))
    step(state, batch)
    go.set()
    mgr.wait()
    _, got, _ = mgr.restore_latest(train_state_tree(state, tcfg,
                                                    device="meta"))
    mine = _flat_np(jax.tree_util.tree_map(lambda t: t.numpy(), got))
    for k, v in want.items():
        np.testing.assert_array_equal(mine[k], v, err_msg=k)
    now = _flat_np(jax.tree_util.tree_map(
        lambda t: t.numpy(), train_state_tree(state, tcfg)))
    moved = sum(not np.array_equal(now[k], v) for k, v in want.items())
    assert moved > len(want) // 2        # the second step did move them


def json_keys(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return jckpt.json.load(f)["keys"]


def test_bf16_state_round_trips_and_the_reference_cannot(tmp_path):
    """C6: a bf16 leaf is stored as its 16-bit pattern with "bfloat16" in
    the manifest and restores bit for bit (NaN and -0.0 included); the
    reference saves the same leaf as raw V2 records and its restore
    raises. The port also restores the reference's V2 file bit for
    bit."""
    bits = np.random.default_rng(2).integers(-2 ** 15, 2 ** 15, (6, 10),
                                             dtype=np.int64).astype(np.int16)
    bits[0, :3] = [0x7FC0, -32768, 0x0001]      # NaN, -0.0, a subnormal
    w = torch.from_numpy(bits).view(torch.bfloat16)
    st = {"params": {"w": w, "b": torch.ones(10)}}
    d = str(tmp_path / "t")
    save_checkpoint(d, 3, st)
    man = jckpt.json.load(open(os.path.join(d, "step_000000003",
                                            "manifest.json")))
    assert man["dtypes"] == {"params::w": "bfloat16"}
    _, got, _ = restore_checkpoint(d, st)
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       w.view(torch.int16))
    jw = jnp.asarray(bits.view(ml_dtypes.bfloat16))
    dj = str(tmp_path / "j")
    jckpt.save_checkpoint(dj, 3, {"params": {"w": jw}})
    with pytest.raises(ValueError):
        jckpt.restore_checkpoint(dj, jax.eval_shape(
            lambda: {"params": {"w": jw}}))
    _, got, _ = restore_checkpoint(dj, {"params": {"w": w}})
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       w.view(torch.int16))


def test_shape_mismatch_raises(tmp_path):
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 1, _state())
    bad = _state()
    bad["opt"]["m"] = torch.zeros(4, 16)
    with pytest.raises(ValueError, match="ckpt shape"):
        restore_checkpoint(d, bad)
