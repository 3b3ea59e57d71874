"""Port parity of distributed training (``parallel.pipeline``,
``optim.compress.quantized_allreduce``, ``launch.steps.make_train_step(
plan=)``, ``runtime.elastic``, ``launch.train`` on a mesh) against the
reference, on gloo ranks spawned by ``launch.mesh.spawn_ranks`` (rank
functions in ``tests/_torch_dist_ranks.py``). The reference's mesh code
runs in a subprocess on virtual host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count``), as
``tests/test_distributed.py::run_py`` does.

* ``quantized_allreduce`` on 3 and 4 ranks equals the reference's ring
  bit for bit, with and without padding, 8 and 16 bits, mean on and off;
  each hop's payload is an int8 (int16) tensor beside a float32 scale.
* ``gpipe_apply`` at S = 4 against the sequential chain and the
  reference's on 4 virtual devices (rtol 2e-5), its gradient against the
  chain's (rtol 1e-5).
* The sharded step on yi-34b-smoke over meshes (2, 1), (1, 2) and (2, 2)
  (2 and 4 ranks) against the port's single-device step and the
  reference's single-device functions (the reference's own sharded step
  fails on this JAX): step 1's gradients gathered whole, within 1e-4 of
  each leaf's largest magnitude; three steps' loss and grad norm at rtol
  1e-4; a batch "data" does not divide; a mask whose token counts differ
  between the shards; each rank's state bytes equal to its spec's. On
  (2, 2) also W10 / D12 / KV8 with int8 moments and the int8 wire, and
  the wire and AdamW on shared gradients bit for bit the unsharded ones;
  xlstm-350m-smoke on (2, 1); a MoE config's step builds on meshes of
  more than one rank, expert-parallel where the reference's is.
* Elastic restore: a state trained on (2, 2) and saved, restored onto
  (4, 1) and onto one rank bit for bit; the checkpoint cross-loads with
  the reference's both ways.
* The CLI under ``torch.distributed.run`` on 2 ranks against one rank,
  its checkpoint resumed on one rank, and ``--mesh single`` refused.
"""
import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_ranks as ranks  # noqa: E402
from _torch_parity import perturbed_jax_params, t  # noqa: E402

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.data.lm import LMDataConfig as JData  # noqa: E402
from repro.data.lm import lm_batch as jlm_batch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.runtime.elastic import divisor_meshes as jdivisors  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import (init_train_state,  # noqa: E402
                                      loss_and_grads, make_train_step,
                                      train_state_tree)
from repro_torch.models.transformer import (params_from_numpy,  # noqa
                                            reference_tree)
from repro_torch.parallel.sharding import (AbstractMesh,  # noqa: E402
                                           plan_for_mesh)
from repro_torch.runtime import divisor_meshes, elastic_restore  # noqa

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = [(2, 1), (1, 2), (2, 2)]
RING_SHAPES = [(12,), (10,), (5, 3), (64,)]     # 10 and 15 pad at n = 4


# ---------------------------------------------------------------------------
# inputs and the single-device targets
# ---------------------------------------------------------------------------
def _ref_batches(vocab, n, B=4, S=32, seed=1):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d = JData(vocab_size=vocab, seq_len=S, batch_size=B, seed=seed)
        return [{k: np.asarray(v) for k, v in jlm_batch(d, i).items()}
                for i in range(n)]


def _grad_batches(b0):
    """Step 1's batches: the whole batch, 3 rows ("data" of 2 does not
    divide them: replicated) and a mask whose first two rows (data shard
    0) keep 29 and 31 tokens and the last two (shard 1) 5 and 2."""
    mask = np.zeros(b0["labels"].shape, np.int32)
    for row, keep in enumerate((29, 31, 5, 2)):
        mask[row, :keep] = 1
    return {"whole": b0, "rows3": {k: v[:3] for k, v in b0.items()},
            "mask": dict(b0, mask=mask)}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.numpy().copy()     # the step updates the state in place


def _port_steps(tcfg, tree, batches, quant=False, starts=None):
    """The port's single-device steps: per step (loss, grad norm); with
    ``starts`` (a list) also each step's starting state, as a global
    numpy tree."""
    state = init_train_state(tcfg, ranks._hp(quant),
                             model=params_from_numpy(tree, tcfg, device="cpu",
                                                     trainable=True))
    step = make_train_step(tcfg, ranks._hp(quant),
                           quant=ranks._quant(tcfg, quant))
    out = []
    for b in batches:
        if starts is not None:
            starts.append(_numpy(train_state_tree(state, tcfg)))
        state, m = step(state, {k: t(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _ref_steps(jcfg, jparams, batches):
    hp = jsteps.TrainHParams(lr=1e-3)
    state = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg, hp)
    state["params"] = jparams
    step = jax.jit(jsteps.make_train_step(jcfg, hp))
    out = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


@pytest.fixture(scope="module")
def single():
    """yi-34b-smoke (and xlstm-350m-smoke) single-device targets: the
    port's and the reference's step-1 gradients and three steps."""
    jcfg, tcfg, jparams, tree = perturbed_jax_params("yi-34b", jit=True)
    batches = _ref_batches(tcfg.vocab_size, 3)
    grads = _grad_batches(batches[0])
    model = params_from_numpy(tree, tcfg, device="cpu", trainable=True)
    port, ref = {}, {}
    for name, b in grads.items():
        m, g = loss_and_grads(model, {k: t(v) for k, v in b.items()}, tcfg)
        port[name] = ({k: float(v.detach()) for k, v in m.items()},
                      {n: x.numpy() for n, x in g.items()})
        fn = jax.jit(jax.value_and_grad(lambda p, b: jtr.train_loss(
            p, b, jcfg), has_aux=True))
        (loss, jm), jg = fn(jparams, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        ref[name] = ({k: float(v) for k, v in jm.items()}, jg)
    starts = []
    quant_steps = _port_steps(tcfg, tree, batches, quant=True, starts=starts)
    _, xt, _, xtree = perturbed_jax_params("xlstm-350m", jit=True)
    xb = _ref_batches(xt.vocab_size, 3, S=64)
    return {"cfg": tcfg, "tree": tree, "model": model, "batches": batches,
            "grads": grads, "port_grads": port, "ref_grads": ref,
            "port_steps": _port_steps(tcfg, tree, batches),
            "ref_steps": _ref_steps(jcfg, jparams, batches),
            "quant_steps": quant_steps, "quant_starts": starts,
            "xlstm": (xt, xtree, xb, _port_steps(xt, xtree, xb)),
            "jcfg": jcfg}


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------
def _ring_cases(n):
    rng = np.random.default_rng(n)
    return [(rng.normal(size=(n,) + s).astype(np.float32), bits, mean)
            for s in RING_SHAPES for bits in (8, 16) for mean in (True, False)]


def _gpipe_cases():
    rng = np.random.default_rng(11)
    S, mb, D = 4, 2, 16
    Ws = (rng.normal(size=(S, D, D)) * 0.3).astype(np.float32)
    return [(Ws, rng.normal(size=(M, mb, D)).astype(np.float32),
             rng.normal(size=(M, mb, D)).astype(np.float32)) for M in (4, 2)]


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory, single):
    """The port's checkpoint directory (written by the (2, 2) ranks) and
    the reference's, written here from a reference train state."""
    root = tmp_path_factory.mktemp("dist_ckpt")
    jcfg = single["jcfg"]
    hp = jsteps.TrainHParams(lr=1e-3)
    jstate = jsteps.init_train_state(jax.random.PRNGKey(3), jcfg, hp)
    jckpt.save_checkpoint(str(root / "ref"), 17, jstate,
                          extra={"data": {"step": 17}})
    return {"port": str(root / "port"), "ref": str(root / "ref")}, \
        _slashed(jstate)


def _slashed(tree):
    """{"a/b/0": numpy} of a JAX tree (``_torch_dist_ranks._flat``'s
    keys)."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def two(single):
    s = single
    xt, xtree, xb = s["xlstm"][:3]
    return tmesh.spawn_ranks(
        ranks.sharded_training, 2, [(2, 1), (1, 2)],
        {"yi": s["cfg"], "xlstm": xt}, {"yi": s["tree"], "xlstm": xtree},
        {"grads": s["grads"], "steps": s["batches"], "xlstm": xb},
        {(2, 1): ("grads", "steps", "xlstm"), (1, 2): ("grads", "steps")},
        {}, device="cpu")


@pytest.fixture(scope="module")
def four(single, ckpt_dirs):
    s = single
    dirs, _ = ckpt_dirs
    return tmesh.spawn_ranks(
        ranks.sharded_training, 4, [(2, 2), (4, 1)], {"yi": s["cfg"]},
        {"yi": s["tree"]},
        {"grads": s["grads"], "steps": s["batches"],
         "quant_starts": s["quant_starts"], "allreduce": _ring_cases(4),
         "gpipe": _gpipe_cases()},
        {(2, 2): ("grads", "steps", "save", "quant"),
         (4, 1): ("elastic", "allreduce"), "gpipe": ()},
        dirs, device="cpu")


@pytest.fixture(scope="module")
def three():
    return tmesh.spawn_ranks(ranks.allreduce_ring, 3, 3, _ring_cases(3),
                             device="cpu")


_REF_VIRTUAL = """
import pickle, sys
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.optim.compress import quantized_allreduce
from repro.parallel.pipeline import gpipe_apply
with open(sys.argv[1], "rb") as f:
    rings, gp = pickle.load(f)
out = {"ring": {}, "gpipe": []}
for n, cases in rings.items():
    # every case in one program (one compile a ring size)
    mesh = Mesh(np.array(jax.devices()[:n]), ("d",))

    def body(*xs):
        return tuple(quantized_allreduce(x[0], "d", bits=bits,
                                         mean=mean)[None]
                     for x, (_, bits, mean) in zip(xs, cases))

    f = shard_map(body, mesh=mesh, in_specs=(P("d"),) * len(cases),
                  out_specs=(P("d"),) * len(cases), check_rep=False)
    res = jax.jit(f)(*[jnp.asarray(x) for x, _, _ in cases])
    out["ring"][n] = [np.asarray(r) for r in res]
mesh = jax.make_mesh((4,), ("stage",))
for ws, x, _ in gp:
    y = gpipe_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws),
                    jnp.asarray(x), mesh=mesh, axis="stage")
    out["gpipe"].append(np.asarray(y))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref_virtual(tmp_path_factory):
    """The reference's ring (3 and 4 devices) and GPipe (4 stages) on
    virtual host devices, in a subprocess."""
    d = tmp_path_factory.mktemp("ref_virtual")
    src, dst = d / "in.pkl", d / "out.pkl"
    with open(src, "wb") as f:
        pickle.dump(({3: _ring_cases(3), 4: _ring_cases(4)},
                     _gpipe_cases()), f)
    code = textwrap.dedent("""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import warnings; warnings.filterwarnings("ignore")
        import jax, jax.numpy as jnp
    """) + _REF_VIRTUAL
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    got = subprocess.run([sys.executable, "-c", code, str(src), str(dst)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert got.returncode == 0, got.stderr
    with open(dst, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# quantized_allreduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [3, 4])
def test_quantized_allreduce_equals_the_references_ring(n, three, four,
                                                        ref_virtual):
    runs = [r[(4, 1)]["allreduce"] for r in four] if n == 4 else three
    want = ref_virtual["ring"][n]
    cases = _ring_cases(n)
    for i, (x, bits, mean) in enumerate(cases):
        for rank in range(n):
            got = runs[rank]["out"][i]
            assert got.shape == x.shape[1:]
            np.testing.assert_array_equal(got, want[i][rank],
                                          err_msg=f"case {i} rank {rank}")
        if bits == 8 and mean:    # the reference's own bound
            ref = x.mean(axis=0)
            rel = np.abs(runs[0]["out"][i] - ref).max() / np.abs(ref).max()
            assert rel < 0.05, rel
    # the wire: every hop an integer payload beside a float32 scale, 2
    # (n - 1) hops a case
    wire = runs[0]["wire"]
    assert len(wire) == len(cases) * 2 * (n - 1)
    kinds = [("torch.int8" if bits == 8 else "torch.int16")
             for _, bits, _ in cases for _ in range(2 * (n - 1))]
    for ops, q in zip(wire, kinds):
        assert ops == (q, "torch.float32", q, "torch.float32"), ops


# ---------------------------------------------------------------------------
# GPipe
# ---------------------------------------------------------------------------
def _sequential(ws, x, cot):
    W = torch.from_numpy(ws).requires_grad_(True)
    h = xt = torch.from_numpy(x).requires_grad_(True)
    for s in range(ws.shape[0]):
        h = torch.tanh(h @ W[s])
    torch.sum(h * torch.from_numpy(cot)).backward()
    return h.detach().numpy(), W.grad.numpy(), xt.grad.numpy()


@pytest.mark.parametrize("case", [0, 1], ids=["M4", "M2"])
def test_gpipe_matches_the_sequential_chain_and_the_reference(
        case, four, ref_virtual):
    ws, x, cot = _gpipe_cases()[case]
    out, wg, xg = _sequential(ws, x, cot)
    for rank, res in enumerate(four):
        got = res["gpipe"][case]
        np.testing.assert_allclose(got["out"], out, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["out"], ref_virtual["gpipe"][case],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got["w_grad"], wg[rank], rtol=1e-5,
                                   atol=1e-6)
        if rank == 0:
            np.testing.assert_allclose(got["x_grad"], xg, rtol=1e-5,
                                       atol=1e-6)
    from repro.parallel.pipeline import pipeline_bubble as jbubble
    from repro_torch.parallel.pipeline import pipeline_bubble
    assert pipeline_bubble(8, 4) == jbubble(8, 4)
    assert abs(pipeline_bubble(8, 4) - 7 / 11) < 1e-9


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------
def _runs(shape, two, four):
    return [r[shape] for r in (two if shape in ((2, 1), (1, 2)) else four)]


def _close_to_max(got, want, tol=1e-4):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("batch", ["whole", "rows3", "mask"])
def test_sharded_gradients_match_single_device(shape, batch, single, two,
                                               four):
    """Step 1's loss terms and gradients, each gathered whole, against
    the port's single-device ``loss_and_grads`` and the reference's
    ``jax.grad``: every leaf within 1e-4 of its largest magnitude. "rows3":
    3 rows, which "data" does not divide (replicated); "mask": a mask
    keeping 60 tokens on data shard 0 and 7 on shard 1, so a mean of
    per-shard means would be wrong."""
    tm, tg = single["port_grads"][batch]
    jm, jg = single["ref_grads"][batch]
    model, cfg = single["model"], single["cfg"]
    jflat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
             jax.tree_util.tree_flatten_with_path(jg)[0]}
    for res in _runs(shape, two, four):
        m, g = res["grads"][batch]
        assert set(m) == set(tm)
        for k in m:
            assert m[k] == pytest.approx(tm[k], rel=1e-5), k
            assert m[k] == pytest.approx(jm[k], rel=1e-5), k
        assert set(g) == set(tg)
        for n in g:
            _close_to_max(g[n], tg[n])
        mine = reference_tree({n: torch.from_numpy(v) for n, v in g.items()},
                              model, cfg, stack=torch.stack)
        flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(mine)[0]}
        assert set(flat) == set(jflat)
        for k in jflat:
            _close_to_max(flat[k], jflat[k])
    if batch == "mask":     # the shards' token counts really differ
        mask = single["grads"]["mask"]["mask"]
        assert mask[:2].sum() == 60 and mask[2:].sum() == 7


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_steps_track_both_single_device_steps(shape, single, two,
                                                      four):
    for res in _runs(shape, two, four):
        for want in (single["port_steps"], single["ref_steps"]):
            np.testing.assert_allclose(res["steps"], want, rtol=1e-4)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_ranks_state_bytes_equal_its_specs(shape, two, four):
    """Every leaf of each rank's state has its spec's local shape, so its
    bytes are the spec's; on more than one rank they are fewer than the
    whole state's."""
    for res in _runs(shape, two, four):
        b = res["bytes"]
        assert b["bad"] == [] and b["have"] == b["want"]
        assert b["have"] < b["whole"]
    if shape == (2, 2):
        for res in _runs(shape, two, four):
            b = res["quant_bytes"]
            assert b["bad"] == [] and b["have"] == b["want"] < b["whole"]


def test_int8_moments_and_wire_on_2x2(single, four):
    """W10 / D12 / KV8 with int8 moments and the int8 wire on (2, 2):
    three steps, each from the single-device run's state before it (Adam
    turns a wire value one grid step apart into a whole step: free
    running, step 3's grad norm parted by 1.04e-4), each step's loss and
    grad norm within rtol 1e-4 of the port's single-device step; on
    shared gradients the wire's output and residual, the moments' int8
    grids and per-row scales and the updated parameters equal the
    unsharded ones bit for bit, over two updates."""
    for res in _runs((2, 2), None, four):
        np.testing.assert_allclose(res["quant"], single["quant_steps"],
                                   rtol=1e-4)
        for i, checks in res["shared"].items():
            assert all(checks.values()), (i, checks)


def test_xlstm_on_2x1_tracks_the_single_device_steps(single, two):
    """xlstm-350m-smoke (mLSTM and sLSTM, two chunks a row) on (2, 1):
    three steps' loss and grad norm within rtol 1e-4 of the port's
    single-device steps (which ``tests/test_torch_train_step.py`` holds
    against the reference's)."""
    port = single["xlstm"][3]
    for res in _runs((2, 1), two, None):
        np.testing.assert_allclose(res["xlstm"], port, rtol=1e-4)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v3-671b", "jamba-v0.1-52b"])
def test_moe_training_under_a_mesh_builds(arch):
    """A MoE config's sharded step builds on meshes of more than one rank
    (expert parallelism is ported: ``tests/test_torch_ep.py`` holds it
    against the reference), and it dispatches expert-parallel exactly
    where the reference's ``moe_apply`` takes ``_sharded_dispatch``:
    ``scatter``, a model axis, and E divisible by it."""
    from repro_torch.models.moe import expert_parallel
    hp = ranks._hp(False)
    for mode in ("eval_all", "scatter"):
        cfg = dataclasses.replace(get_smoke_config(arch), moe_mode=mode)
        for shape in ((2, 1), (1, 2), (1, 3), (1, 1)):
            plan = plan_for_mesh(AbstractMesh(shape, ("data", "model")))
            make_train_step(cfg, hp, plan=plan)
            want = mode == "scatter" and cfg.num_experts % shape[1] == 0
            assert expert_parallel(cfg, plan) == want, (mode, shape)
        host = plan_for_mesh(AbstractMesh((2,), ("data",)))
        make_train_step(cfg, hp, plan=host)
        assert not expert_parallel(cfg, host)


# ---------------------------------------------------------------------------
# elastic restore
# ---------------------------------------------------------------------------
def test_elastic_restore_across_meshes(single, four, ckpt_dirs):
    """The state trained on (2, 2) and saved (gathered whole, rank 0
    writing) restores onto (4, 1) and onto one rank bit for bit; the
    reference reads that checkpoint, and the port restores the
    reference's onto (4, 1), both bit for bit."""
    dirs, jflat = ckpt_dirs
    cfg = single["cfg"]
    saved = four[0][(2, 2)]["saved"]
    for r, res in enumerate(four):
        got = res[(4, 1)]["elastic"]
        port, ref = got["port"], got["ref"]
        assert port["step"] == 3 and port["extra"] == {"data": {"step": 3}}
        assert ref["step"] == 17
        assert set(port["tree"]) == set(saved)
        for k, v in saved.items():
            np.testing.assert_array_equal(port["tree"][k], v, err_msg=k)
        # the (4, 1) plan shards the embedding's rows four ways
        assert port["local"]["embed"][0] == cfg.vocab_size // 4
        assert set(ref["tree"]) == set(jflat)
        for k, v in jflat.items():
            np.testing.assert_array_equal(ref["tree"][k], v, err_msg=k)
    # the reference's restore of the port's sharded save
    tmpl = jax.eval_shape(lambda k: jsteps.init_train_state(
        k, single["jcfg"], jsteps.TrainHParams(lr=1e-3)),
        jax.random.PRNGKey(0))
    step, back, _ = jckpt.restore_checkpoint(dirs["port"], tmpl)
    assert step == 3
    back = _slashed(back)
    assert set(back) == set(saved)
    for k, v in back.items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    # onto one rank (a one-rank group here)
    import torch.distributed as dist
    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_host_mesh("cpu")
        tmpl = init_train_state(cfg, ranks._hp(False), seed=9, device="cpu")
        step, state, _ = elastic_restore(dirs["port"], tmpl, mesh)
        one = ranks._flat(train_state_tree(state, cfg))
    finally:
        tmesh.close_process_group()
    assert step == 3 and set(one) == set(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(one[k], v, err_msg=k)
    assert divisor_meshes(8) == jdivisors(8)
    assert divisor_meshes(12) == jdivisors(12)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_on_two_ranks_resumes_on_one(tmp_path):
    """``torch.distributed.run --nproc-per-node 2`` on yi-34b-smoke for 6
    steps (a checkpoint every 2) against one rank: losses and grad norms
    within rtol 1e-4; rank 0 alone prints and writes the metrics and the
    checkpoints. Its step-4 checkpoint resumed on one rank equals the
    one-rank run's steps 5 and 6 at rtol 1e-4. ``--mesh single`` without
    a 256-rank group raises the production mesh's ValueError."""
    base = ["--arch", "yi-34b", "--smoke", "--device", "cpu", "--steps", "6",
            "--batch-size", "4", "--seq-len", "32", "--lr", "1e-3",
            "--warmup", "2", "--log-every", "1"]
    ck, m2 = tmp_path / "ck", tmp_path / "m2.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", "2", "--master-port", str(tmesh.free_port()),
           "-m", "repro_torch.launch.train"] + base + [
        "--ckpt-dir", str(ck), "--ckpt-interval", "2", "--metrics-out",
        str(m2)]
    got = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.count("[train] step") == 6    # rank 0 prints alone
    two = json.loads(m2.read_text())
    one = train_mod.main(base)
    assert [r["step"] for r in two] == [r["step"] for r in one]
    for a, b in zip(two, one):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    assert sorted(os.listdir(ck)) == [f"step_{s:09d}" for s in (2, 4, 6)]
    manifest = json.loads((ck / "step_000000004" / "manifest.json")
                          .read_text())
    assert manifest["extra"] == {"data": {"step": 4}}
    import shutil
    shutil.rmtree(ck / "step_000000006")
    resumed = train_mod.main(base + ["--ckpt-dir", str(ck), "--resume"])
    assert [r["step"] for r in resumed] == [5, 6]
    for a, b in zip(resumed, one[4:]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
    with pytest.raises(ValueError, match="exactly 256 ranks"):
        train_mod.main(base + ["--mesh", "single"])


def test_cli_mesh_single_refuses_a_group_of_the_wrong_size():
    """``--mesh single`` / ``multi`` train over the reference's 256- and
    512-rank pods (``make_production_mesh``): a running group of another
    size (the dry run's fake group of 8 here) is refused with the mesh's
    ValueError, naming both sizes, and the trainer leaves the group it
    did not open running."""
    import torch.distributed as dist
    base = ["--arch", "yi-34b", "--smoke", "--device", "cpu", "--steps", "1",
            "--batch-size", "2", "--seq-len", "16"]
    with tmesh.fake_group(8):
        for mesh, n in (("single", 256), ("multi", 512)):
            with pytest.raises(ValueError, match=f"exactly {n} ranks "
                               r"\(256 single-pod, 512 multi-pod\); the "
                               "running group has 8"):
                train_mod.main(base + ["--mesh", mesh])
        assert dist.is_initialized() and dist.get_world_size() == 8
    assert not dist.is_initialized()
