"""Port parity of expert parallelism (``models.moe`` under
``parallel.hints.train_step_mark``, the all-to-all and its int8 / int16
wire, MoE training through ``launch.steps.make_train_step(plan=)`` and
MoE serving under ``BatchedServer(mesh=)``) against the reference, on
gloo ranks spawned by ``launch.mesh.spawn_ranks`` (rank functions in
``tests/_torch_ep_ranks.py``). The reference's mesh code runs in a
subprocess on 4 virtual host devices (``tests/_torch_ep_ref.py``), beside
the spawned ranks.

* The dispatch: the port's ``moe_apply`` (scatter) on (2, 2) and (1, 2)
  against the reference's ``_sharded_dispatch`` at wire widths 0, 8 and
  16 (float32): the output within 1e-5, on cases whose sequence the model
  axis does not divide, whose rows the data axis does not divide, whose
  capacity drops tokens, and a top-1 softmax router; at 16 bits a
  rounding of the expert outputs one grid step apart may differ by that
  step (the two packages' GEMMs sum in different orders). Gradients at 0
  bits against the reference's ``jax.grad``, at 8 and 16 bits against the
  same dispatch with a straight-through wire: within 1e-4 of each leaf's
  largest magnitude. The wire carries int8 / int16 payloads beside
  float32 scales (int16 sent as its bytes), never the floats; its scales
  and payload are the reference's arithmetic as XLA compiles it (a
  reciprocal multiply for the division by qmax) bit for bit.
* The load-balance loss on (2, 1), (1, 2) and (2, 2) equals the global
  batch's, and its router gradient summed over the ranks is the
  single-device one.
* Sharded train steps on (2, 1), (1, 2) and (2, 2): llama4-maverick-smoke
  (eval_all) and jamba-smoke against the port's single-device step;
  deepseek-v3-smoke in ``scatter`` (MTP included) against the
  reference's train step under each mesh's hints: step 1's gradients
  within 1e-4 of each leaf's largest magnitude, three steps' loss and
  grad norm at rtol 1e-4, each rank's state bytes its spec's, the state
  through its gathered tree (a checkpoint's) and back bit for bit; the int8
  moments' and the wire's per-row and per-leaf reductions on expert
  shards bit for bit the unsharded ones. On a one-rank mesh the step at
  ``moe_a2a_bits`` 0 is the plain step bit for bit, and at 8 it applies
  the wire, as the reference's does (C10-port).
* Serving: llama4-maverick-smoke at tp = 2 (eval_all and scatter)
  against tp = 1 and the reference's server: teacher-forced step logits
  within 1e-4, every counter equal, the experts split E / 2; with
  ``moe_a2a_bits`` 8 the served logits are the unwired ones bit for bit
  (the server never takes the train step's expert-parallel dispatch).
* The CLI: ``torch.distributed.run`` of ``launch.train --mesh host`` on
  llama4-maverick-smoke over 2 ranks against one rank.
"""
import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_ranks as dist_ranks  # noqa: E402
import _torch_ep_ranks as ranks  # noqa: E402
import _torch_tp_ranks as tp_ranks  # noqa: E402
from _torch_bench import GATE  # noqa: E402
from _torch_parity import perturbed_jax_params  # noqa: E402

from repro.data.lm import LMDataConfig as JData  # noqa: E402
from repro.data.lm import lm_batch as jlm_batch  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro_torch.benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro_torch.configs.registry import get_smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models.moe import _route  # noqa: E402
from repro_torch.models.transformer import (params_from_numpy,  # noqa
                                            reference_tree)

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LLAMA, DSV3, JAMBA = ("llama4-maverick-400b-a17b", "deepseek-v3-671b",
                      "jamba-v0.1-52b")
ARCHS = (LLAMA, DSV3, JAMBA)
OVER = {LLAMA: {}, DSV3: dict(moe_mode="scatter"), JAMBA: {}}
MESHES = [(2, 1), (1, 2), (2, 2)]
# (2, 1, 2) is a pod mesh: a batch that "pod" x "data" does not divide
# splits its rows over "data" alone
DISPATCH_MESHES = [(2, 2), (1, 2), (2, 1, 2)]
BITS = (0, 8, 16)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------
def _moe_inputs():
    """One MoE layer of deepseek-v3-smoke's widths (D 64, E 4, F 48, a
    shared expert), its router drawn wide enough to route decisively, and
    the dispatch cases: (name, config overrides, x, cotangent)."""
    rng = np.random.default_rng(0)
    D, E, F = 64, 4, 48

    def n(*s, std=1.0):
        return (rng.normal(size=s) * std).astype(np.float32)

    params = {"router": n(D, E, std=0.3),
              "experts": {"w_gate": n(E, D, F, std=D ** -0.5),
                          "w_up": n(E, D, F, std=D ** -0.5),
                          "w_down": n(E, F, D, std=F ** -0.5)},
              "shared": {"w_gate": n(D, F, std=D ** -0.5),
                         "w_up": n(D, F, std=D ** -0.5),
                         "w_down": n(F, D, std=F ** -0.5)}}
    cases = []
    for name, over, B, S in (
            ("base", {}, 4, 8),
            ("odd_seq", {}, 4, 5),           # "model" does not divide S
            ("rows3", {}, 3, 8),             # "data" does not divide B
            ("drops", dict(moe_capacity_factor=0.5), 4, 8),
            ("softmax_k1", dict(moe_sigmoid_router=False,
                                experts_per_token=1), 4, 8)):
        cases.append((name, over, n(B, S, D), n(B, S, D)))
    return params, cases


def _batches(vocab, n, B=4, S=32, seed=1):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        d = JData(vocab_size=vocab, seq_len=S, batch_size=B, seed=seed)
        return [{k: np.asarray(v) for k, v in jlm_batch(d, i).items()}
                for i in range(n)]


@pytest.fixture(scope="module")
def inputs():
    params, cases = _moe_inputs()
    cfgs, trees, jtrees, batches = {}, {}, {}, {}
    for arch in ARCHS:
        _, tcfg, _, tree = perturbed_jax_params(arch, jit=True)
        cfgs[arch] = dataclasses.replace(tcfg, **OVER[arch])
        trees[arch] = tree
        batches[arch] = _batches(tcfg.vocab_size, 3)
    return {"params": params, "cases": cases, "cfgs": cfgs, "trees": trees,
            "batches": batches}


@pytest.fixture(scope="module")
def ref_proc(inputs, tmp_path_factory):
    """The reference's subprocesses, one a job, started first so that
    they run beside each other and the spawned ranks."""
    d = tmp_path_factory.mktemp("ep_ref")
    jobs = {"dispatch": {"arch": DSV3, "params": inputs["params"],
                         "cases": inputs["cases"],
                         "shapes": DISPATCH_MESHES, "bits": BITS},
            "train": {"arch": DSV3, "over": OVER[DSV3],
                      "params": inputs["trees"][DSV3],
                      "batches": inputs["batches"][DSV3],
                      "shapes": MESHES}}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    for name, job in jobs.items():
        src, dst = d / f"{name}_in.pkl", d / f"{name}_out.pkl"
        with open(src, "wb") as f:
            pickle.dump({name: job}, f)
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_torch_ep_ref.py"),
             str(src), str(dst)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True), dst)
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def ref(ref_proc):
    out = {}
    for proc, dst in ref_proc.values():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with open(dst, "rb") as f:
            out.update(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-device targets: step 1's metrics and
    gradients, three steps' losses and grad norms."""
    out = {}
    for arch in ARCHS:
        cfg, tree = inputs["cfgs"][arch], inputs["trees"][arch]
        model = params_from_numpy(tree, cfg, device="cpu", trainable=True)
        b = {k: torch.from_numpy(v) for k, v in
             inputs["batches"][arch][0].items()}
        m, g = loss_and_grads(model, b, cfg)
        steps = _port_steps(cfg, tree, inputs["batches"][arch])
        out[arch] = ({k: float(v.detach()) for k, v in m.items()},
                     {n: x.numpy() for n, x in g.items()}, steps)
    return out


def _port_steps(cfg, tree, batches):
    from repro_torch.launch.steps import init_train_state, make_train_step
    state = init_train_state(cfg, dist_ranks._hp(False),
                             model=params_from_numpy(tree, cfg, device="cpu",
                                                     trainable=True))
    step = make_train_step(cfg, dist_ranks._hp(False))
    out = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def _rank_inputs(inputs, serve=None):
    base = get_smoke_config(DSV3)
    lb = {"base": inputs["cases"][0][2],
          "rows3": inputs["cases"][2][2]}
    out = {"dispatch": {"cfg": base, "params": inputs["params"],
                        "cases": inputs["cases"], "bits": BITS,
                        "lb_inputs": lb},
           "train": {"cfgs": inputs["cfgs"], "trees": inputs["trees"],
                     "batches": inputs["batches"]}}
    if serve is not None:
        out["serve"] = serve
    return out


TRAIN = {"grads": ARCHS}


@pytest.fixture(scope="module")
def two(inputs, ref_proc, served):
    return tmesh.spawn_ranks(
        ranks.ep_ranks, 2, [(2, 1), (1, 2), (2,)],
        {(2, 1): {"lb": 1, "train": TRAIN},
         (1, 2): {"dispatch": 1, "lb": 1, "train": TRAIN},
         (2,): {"train": {"grads": (DSV3,)}},
         "serve": 1},
        _rank_inputs(inputs, served["rank_inputs"]), device="cpu")


@pytest.fixture(scope="module")
def four(inputs, ref_proc):
    return tmesh.spawn_ranks(
        ranks.ep_ranks, 4, [(2, 2), (2, 1, 2)],
        {(2, 2): {"dispatch": 1, "lb": 1,
                  "train": dict(TRAIN, shared=DSV3)},
         (2, 1, 2): {"dispatch": 1}},
        _rank_inputs(inputs), device="cpu")


def _runs(shape, two, four):
    return [r[shape] for r in (four if np.prod(shape) == 4 else two)]


def _close_to_max(got, want, tol=1e-4):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _row_slice(rank_res, shape, rank, B):
    """This rank's rows of a global batch of B rows: its block over the
    axes that split them, major first (mesh axes ("data", "model") or
    ("pod", "data", "model"))."""
    names = ("pod", "data", "model")[-len(shape):]
    size = dict(zip(names, shape))
    coord, r = {}, rank
    for ax in reversed(names):
        coord[ax], r = r % size[ax], r // size[ax]
    idx, parts = 0, 1
    for ax in rank_res["row_axes"]:
        idx, parts = idx * size[ax] + coord[ax], parts * size[ax]
    n = B // parts
    return slice(idx * n, (idx + 1) * n)


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", DISPATCH_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_ep_dispatch_matches_the_references(shape, bits, inputs, two, four,
                                            ref):
    want_all = ref["dispatch"][shape]
    flips = 0
    for rank, res in enumerate(_runs(shape, two, four)):
        for name, over, x, _ in inputs["cases"]:
            got = res["dispatch"][(name, bits)]
            want = want_all[name][bits]
            rows = _row_slice(got, shape, rank, x.shape[0])
            diff = np.abs(got["y"] - want["y"][rows])
            if bits == 16:
                # a one-step flip of the 32767-step grid of one expert
                # output row (up to ~4.2e-5 here); the rest within 1e-5
                flips += int((diff > 1e-5).sum())
                assert diff.max() < 1e-4, (name, diff.max())
                assert (diff > 1e-5).mean() < 0.01, (name, flips)
            else:
                assert diff.max() < 1e-5, (name, rank, diff.max())
            assert got["lb"] == pytest.approx(want["lb"], rel=1e-5, abs=1e-6)
            # the gradients: the reference's, or with the wire on, the
            # straight-through dispatch's (whose forward is the
            # reference's)
            key = "" if bits == 0 else "ste_"
            if bits:
                np.testing.assert_array_equal(want["ste_y"], want["y"])
            for leaf, g in want[key + "grads"].items():
                _close_to_max(got["grads"][leaf], g)
            _close_to_max(got["x_grad"], want[key + "x_grad"][rows])
            # E / tp experts a rank, whole in F
            assert got["local_experts"] == (4 // shape[-1], 64, 48)
    if bits == 16:
        print(f"[ep] {shape} 16 bits: {flips} output values one grid step "
              f"apart")


def test_the_wire_carries_integers(two, four):
    """Every exchange of the forward carries the wire's integer payload or
    its float32 scales (int16 sent as its bytes); the backward's exchanges
    carry the float32 gradient (straight-through)."""
    for shape in DISPATCH_MESHES:
        for res in _runs(shape, two, four):
            for (name, bits), got in res["dispatch"].items():
                w = got["wire"]
                if not bits:
                    assert set(w["payload"]) == {"torch.float32"}
                    assert len(w["payload"]) == 4      # 2 out, 2 back
                    continue
                q = "torch.int8" if bits == 8 else "torch.int16"
                # forward: (payload, scales) out and back; backward: two
                # float exchanges
                assert w["payload"] == [q, "torch.float32"] * 2 + [
                    "torch.float32"] * 2, (name, w)
                assert w["sent"] == ["torch.int8", "torch.float32"] * 2 + [
                    "torch.float32"] * 2, (name, w)


@pytest.mark.parametrize("bits", [8, 16])
def test_the_wire_scale_is_xlas_compiled_division(bits):
    """The wire's per-row scale and integer payload equal the reference's
    ``_a2a`` arithmetic as XLA compiles it (``jax.jit``: the absmax's
    division by the constant qmax becomes a multiply by its float32
    reciprocal) bit for bit; a true division differs on some rows, so
    the dispatch's bitwise output depends on this."""
    import jax.numpy as jnp
    from repro_torch.parallel.hints import _wire_encode
    rng = np.random.default_rng(bits)
    t = (rng.normal(size=(4096, 64)) * rng.uniform(0.1, 10, (4096, 1))
         ).astype(np.float32)
    qmax = 2.0 ** (bits - 1) - 1

    def ref(t):     # the reference's _a2a (src/repro/models/moe.py)
        scale = jnp.max(jnp.abs(t), axis=-1, keepdims=True) \
            .astype(jnp.float32) / qmax
        scale = jnp.maximum(scale, 1e-12)
        q = jnp.clip(jnp.round(t.astype(jnp.float32) / scale), -qmax, qmax)
        return q.astype(jnp.int8 if bits <= 8 else jnp.int16), scale

    want_q, want_s = (np.asarray(a) for a in jax.jit(ref)(jnp.asarray(t)))
    q, s = _wire_encode(torch.from_numpy(t), bits)
    np.testing.assert_array_equal(s.numpy(), want_s)
    np.testing.assert_array_equal(q.numpy(), want_q)
    assert str(q.dtype) == ("torch.int8" if bits == 8 else "torch.int16")
    divided = np.abs(t).max(-1, keepdims=True) / np.float32(qmax)
    assert (divided != want_s).any()


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_load_balance_loss_is_the_global_batchs(shape, inputs, two, four):
    base = get_smoke_config(DSV3)
    params = inputs["params"]
    for name, x in (("base", inputs["cases"][0][2]),
                    ("rows3", inputs["cases"][2][2])):
        import types
        router = torch.from_numpy(params["router"].copy()).requires_grad_()
        _, _, aux = _route(types.SimpleNamespace(router=router),
                           torch.from_numpy(x), base)
        aux["moe_lb_loss"].backward()
        for res in _runs(shape, two, four):
            got = res["lb"][name]
            assert got["lb"] == pytest.approx(float(aux["moe_lb_loss"]),
                                              rel=1e-6)
            _close_to_max(got["router_grad"], router.grad.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# the sharded train step
# ---------------------------------------------------------------------------
def _tree_flat(grads, cfg, tree):
    model = params_from_numpy(tree, cfg, device="cpu", trainable=True)
    mine = reference_tree({n: torch.from_numpy(v) for n, v in grads.items()},
                          model, cfg, stack=torch.stack)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(mine)[0]}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS, ids=lambda a: a.split("-")[0])
def test_moe_sharded_steps(arch, shape, inputs, single, two, four, ref):
    """Step 1's metrics and gradients (gathered whole), three steps'
    losses and grad norms, and each rank's state bytes."""
    cfg = inputs["cfgs"][arch]
    if arch == DSV3:
        want = ref["train"][shape]
        wm, wsteps = want["metrics"], want["steps"]
    else:
        wm, wg, wsteps = single[arch]
    for res in _runs(shape, two, four):
        got = res["train"][arch]
        m, g = got["grads"]
        for k in wm:
            assert m[k] == pytest.approx(wm[k], rel=1e-5), k
        if arch == DSV3:
            flat = _tree_flat(g, cfg, inputs["trees"][arch])
            assert set(flat) == set(want["grads"])
            for k, v in want["grads"].items():
                _close_to_max(flat[k], v)
        else:
            assert set(g) == set(wg)
            for n in g:
                _close_to_max(g[n], wg[n])
        np.testing.assert_allclose(got["steps"], wsteps, rtol=1e-4)
        b = got["bytes"]
        assert b["bad"] == [] and b["have"] == b["want"] < b["whole"]
        # the state keeps E / tp experts a rank whatever the dispatch,
        # and its tree (a checkpoint's) holds every expert
        assert got["local_experts"][0] == cfg.num_experts // shape[1]
        rt = got["round_trip"]
        assert rt["equal"] and rt["leaves"] > 0
        assert rt["expert_shape"][-3:] == (cfg.num_experts, cfg.d_model,
                                           cfg.moe_d_ff)


def test_scatter_on_the_host_mesh_dispatches_the_global_batch(single,
                                                             two):
    """On the trainer's host mesh ("data" only: no model axis, so no
    expert parallelism, as the reference's ``moe_apply`` decides) a
    ``scatter`` MoE dispatches the global batch with its capacity, the
    rows gathered from the other rank: deepseek-v3-smoke's step 1 and
    three steps on 2 ranks track the single-device step (gradients within
    1e-4 of each leaf's largest magnitude, rtol 1e-4)."""
    wm, wg, wsteps = single[DSV3]
    for res in two:
        got = res[(2,)]["train"][DSV3]
        m, g = got["grads"]
        for k in wm:
            assert m[k] == pytest.approx(wm[k], rel=1e-5), k
        for n in g:
            _close_to_max(g[n], wg[n])
        np.testing.assert_allclose(got["steps"], wsteps, rtol=1e-4)


def test_expert_shards_reduce_as_the_whole(four):
    """The int8 wire and AdamW with int8 moments on shared gradients over
    deepseek-v3-smoke's leaves on (2, 2) (the expert stacks' q grids and
    per-row scales sharded E over "model" and F over "data"): bit for bit
    the unsharded ones, over two updates."""
    for res in _runs((2, 2), None, four):
        for i, checks in res["train"]["shared"].items():
            assert all(checks.values()), (i, checks)


@pytest.fixture(scope="module")
def one(inputs):
    return tmesh.spawn_ranks(ranks.world_one, 1, inputs["cfgs"][DSV3],
                             inputs["trees"][DSV3],
                             inputs["batches"][DSV3][0], device="cpu")[0]


def test_world_one_mesh_applies_the_wire_as_the_reference(one, ref):
    """C10-port: under a (1, 1) plan a scatter MoE dispatches as the
    reference's ``_sharded_dispatch`` (E % 1 == 0), so at
    ``moe_a2a_bits`` 8 its wire quantizes the dispatch: the mesh step's
    loss is the reference's under a one-device mesh's hints, and differs
    from the plain step's, as the reference's differs from its own
    unhinted loss; at 0 bits the mesh step is the plain step bit for
    bit."""
    zero, eight = one[0], one[8]
    assert zero["mesh"] == zero["plain"] and zero["params_equal"]
    w = ref["train"]["world1"]
    assert eight["mesh"]["loss"] == pytest.approx(w["wired"]["loss"],
                                                  rel=1e-5)
    assert eight["plain"]["loss"] == pytest.approx(w["plain"]["loss"],
                                                   rel=1e-5)
    assert eight["plain"]["loss"] == zero["plain"]["loss"]
    assert abs(eight["mesh"]["loss"] - eight["plain"]["loss"]) > 1e-5
    assert abs(w["wired"]["loss"] - w["plain"]["loss"]) > 1e-5
    assert not eight["params_equal"]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
SERVE_KW = dict(batch_size=2, max_len=48, page_size=8, kv_bits=8,
                attn_impl="gather")
SERVE_CASES = {"eval_all": (dict(moe_mode="eval_all"), SERVE_KW),
               "scatter": (dict(moe_mode="scatter"), SERVE_KW),
               # the server never takes the train step's expert-parallel
               # dispatch, so the wire's width changes nothing served
               "scatter_wire8": (dict(moe_mode="scatter", moe_a2a_bits=8),
                                 SERVE_KW)}


def _serve_requests(vocab):
    rng = np.random.default_rng(4)
    return [(i, rng.integers(0, vocab, 5 + 3 * i).tolist(), 5)
            for i in range(4)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """llama4-maverick-smoke served by the reference and by the port at
    tp = 1 (teacher-forced by the reference's tokens), and the inputs of
    the tp = 2 ranks."""
    jcfg, tcfg, jparams, tree = perturbed_jax_params(LLAMA, seed=2,
                                                     jit=True)
    model = params_from_numpy(tree, tcfg, device="cpu")
    reqs = _serve_requests(tcfg.vocab_size)
    ref, one = {}, {}
    for name, (over, kw) in SERVE_CASES.items():
        jsrv = JServer(dataclasses.replace(jcfg, **over), jparams, **kw)
        tap = _JTap(jsrv)
        jsrv.decode = tap
        done = jsrv.run([JRequest(r, np.asarray(p, np.int32), m)
                         for r, p, m in reqs])
        ref[name] = {"tokens": [list(r.out) for r in done],
                     "logits": tap.logits,
                     "counters": tp_ranks.host_counters(jsrv)}
        forced = {r.rid: list(r.out) for r in done}
        toks, logits, counters, _ = tp_ranks.serve_case(
            dataclasses.replace(tcfg, **over), model, kw, reqs, forced)
        one[name] = {"tokens": toks, "logits": logits, "counters": counters,
                     "forced": forced}
    path = tmp_path_factory.mktemp("ep_serve") / "model.pt"
    torch.save(model.state_dict(), path)
    return {"cfg": tcfg, "ref": ref, "one": one,
            "rank_inputs": {"cfg": tcfg, "path": str(path),
                            "cases": SERVE_CASES, "requests": reqs,
                            "forced": {n: one[n]["forced"]
                                       for n in SERVE_CASES}}}


class _JTap:
    """Records the reference server's step logits."""

    def __init__(self, srv):
        self.srv, self.fn, self.logits = srv, srv.decode, {}

    def __call__(self, params, tokens, pos, caches, pt):
        live = [(i, r) for i, r in enumerate(self.srv.slots) if r is not None]
        nxt, logits, caches = self.fn(params, tokens, pos, caches, pt)
        arr = np.asarray(logits)
        for i, r in live:
            self.logits[(r.rid, self.srv.slot_gen[i])] = arr[i]
        return nxt, logits, caches


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_tp2_moe_serving(name, served, two):
    cfg, ref, one = served["cfg"], served["ref"][name], served["one"][name]
    r0, r1 = (res["serve"][name] for res in two)
    assert set(r0["logits"]) == set(one["logits"]) == set(ref["logits"])
    worst = {"tp1": 0.0, "ref": 0.0}
    for key, lg in r0["logits"].items():
        worst["tp1"] = max(worst["tp1"],
                           float(np.abs(lg - one["logits"][key]).max()))
        worst["ref"] = max(worst["ref"],
                           float(np.abs(lg - ref["logits"][key]).max()))
    print(f"[ep] tp2 {name}: {len(r0['logits'])} step logits, max |diff| "
          f"{worst}")
    assert max(worst.values()) < 1e-4, worst
    for want in (one["tokens"], ref["tokens"]):
        gate = accuracy_gate(want, r0["tokens"], **GATE)
        assert gate["passed"], gate
    assert r0["tokens"] == r1["tokens"]
    assert r0["counters"] == r1["counters"] == one["counters"]
    shared = set(ref["counters"]) & set(one["counters"])
    assert len(shared) > 10
    assert {k: one["counters"][k] for k in shared} == \
        {k: ref["counters"][k] for k in shared}
    E, F = cfg.num_experts, cfg.moe_d_ff
    assert r0["experts"] == (E // 2, cfg.d_model, F)
    assert r0["shared_down"] == (F * cfg.num_shared_experts // 2,
                                 cfg.d_model)
    if name == "scatter_wire8":
        for rank in two:
            assert rank["serve"][name]["logits"].keys() == \
                rank["serve"]["scatter"]["logits"].keys()
            for key, lg in rank["serve"][name]["logits"].items():
                np.testing.assert_array_equal(
                    lg, rank["serve"]["scatter"]["logits"][key])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_trains_llama4_on_two_ranks(tmp_path):
    """``torch.distributed.run --nproc-per-node 2 -m repro_torch.launch.
    train --arch llama4-maverick-400b-a17b --smoke --mesh host`` against
    one rank: losses and grad norms within rtol 1e-4."""
    base = ["--arch", LLAMA, "--smoke", "--device", "cpu", "--steps", "4",
            "--batch-size", "4", "--seq-len", "32", "--lr", "1e-3",
            "--warmup", "2", "--log-every", "1"]
    m2 = tmp_path / "m2.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", "2", "--master-port", str(tmesh.free_port()),
           "-m", "repro_torch.launch.train"] + base + [
        "--metrics-out", str(m2)]
    got = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-3000:]
    assert got.stdout.count("[train] step") == 4
    two = json.loads(m2.read_text())
    one = train_mod.main(base)
    assert [r["step"] for r in two] == [r["step"] for r in one] == [1, 2, 3,
                                                                     4]
    for a, b in zip(two, one):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)
