"""Port parity of the mesh plan and tensor-parallel serving
(``launch/mesh.py``, ``parallel/``, ``BatchedServer(mesh=)``) against the
reference.

* Placements: every port parameter's and every paged-pool leaf's
  placement equals the reference's PartitionSpec of the same leaf
  (matched through ``reference_layout``: a layer leaf's period axis
  dropped), for the dense, hybrid, recurrent, VLM and MoE families
  (qwen2-72b, jamba-v0.1-52b, xlstm-350m, qwen2-vl-2b,
  llama4-maverick), smoke and published, on meshes (1, 2), (2, 2) and
  (16, 16), the pools also on (1, 4), where the smoke configs' 2 KV
  heads stay whole (the reference's rules on an ``AbstractMesh``, the
  port's on its own).
* The parity traps, on 2 gloo ranks: a page-scale write over each rank's
  KV-head shard keeps the replicated scales equal to the whole write's,
  bit for bit (and a shard alone would not); the argmax over vocab
  shards breaks ties at the lowest index, as unsharded.
* tp = 2 on gloo (spawned ranks) against the port's tp = 1 and the
  reference's single-device server, on one trace with the prefix cache
  and the host tier on, at kv-bits 8 and 4, static and page scales, both
  attention routes: teacher-forced step logits within 1e-4 (float32),
  tokens by ``accuracy_gate``, every host counter of both ranks equal to
  tp = 1's, page scales bitwise equal across ranks, a page's local shard
  byte-exact through the host tier, and the shared prefix store keeping
  tp = 1 and tp = 2 pages apart.
* The deadline-miss predictor's one wall-clock feature reads rank 0's
  clock on every rank, so the ranks' schedulers admit alike.
* ``make_host_mesh`` and ``make_test_mesh`` over a running group and
  alone.
* The refusals that remain are the reference's, in its words (an MLA
  model's pages, the encoder at the CLI); the CLI's ``--tp 2`` on the
  dense and the recurrent families. (The other families, a pool tp does
  not divide, a MoE whose experts it does not divide and the quant tier
  serve at tp = 2 and 4: ``tests/test_torch_tp_families.py``,
  ``tests/test_torch_tp4.py``.)
"""
import itertools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

import _torch_tp_ranks as ranks  # noqa: E402
from _torch_bench import GATE, reference_model  # noqa: E402
from _torch_bench import reference_params  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import get_smoke_config as jsmoke  # noqa: E402
from repro.core.paged_kv import PagedCacheSpec as JPagedSpec  # noqa: E402
from repro.launch.mesh import make_serving_mesh as jmesh  # noqa: E402
from repro.launch.serve import BatchedServer as JServer  # noqa: E402
from repro.launch.serve import Request as JRequest  # noqa: E402
from repro.models.transformer import init_cache as jinit_cache  # noqa: E402
from repro.models.transformer import init_model as jinit_model  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro.core.fixedpoint import FixedPointFormat as JFmt  # noqa: E402
from repro.core.policy import PrecisionPolicy as JPolicy  # noqa: E402
from repro.quant.apply import build_model_quant as jbuild  # noqa: E402
from repro.quant.apply import transformer_layer_names as jnames  # noqa: E402
from repro_torch import parallel  # noqa: E402
from repro_torch.benchmarks.lm_precision import accuracy_gate  # noqa: E402
from repro_torch.configs.counting import (layer_signatures,  # noqa: E402
                                          segment_layers)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat  # noqa: E402
from repro_torch.core.paged_kv import PagedCacheSpec  # noqa: E402
from repro_torch.core.policy import PrecisionPolicy  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.transformer import (Transformer,  # noqa: E402
                                            init_cache, reference_layout)
from repro_torch.quant.apply import (build_model_quant,  # noqa: E402
                                     transformer_layer_names)
from repro_torch.parallel.sharding import (AbstractMesh,  # noqa: E402
                                           paged_pool_shardings,
                                           paged_pool_specs, param_shardings,
                                           param_specs, plan_for_mesh)

CPU = torch.device("cpu")
MESHES = [(1, 2), (2, 2), (16, 16)]


# ---------------------------------------------------------------------------
# Placements against the reference's PartitionSpecs
# ---------------------------------------------------------------------------
def _ref_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


ARCHS = ["qwen2-72b", "jamba-v0.1-52b", "xlstm-350m", "qwen2-vl-2b",
         "llama4-maverick-400b-a17b"]


def _configs(arch, which):
    from repro_torch.configs.registry import get_smoke_config as tsmoke
    if which == "smoke":
        return jsmoke(arch), tsmoke(arch)
    return jget_config(arch), get_config(arch)


def _family_cases(*axes):
    """Every family x the product of ``axes`` (lists of (id, value)),
    qwen2-72b's cases under their ids without the arch (the dense
    decoder's cases from before the other families)."""
    out = []
    for arch in ARCHS:
        for combo in itertools.product(*axes):
            ids = "-".join(i for i, _ in combo)
            out.append(pytest.param(
                arch, *(v for _, v in combo),
                id=ids if arch == "qwen2-72b" else f"{arch}-{ids}"))
    return out


def _mesh_axis(meshes):
    return [(f"{a}x{b}", (a, b)) for a, b in meshes]


@pytest.mark.parametrize("arch,which,shape", _family_cases(
    [("smoke", "smoke"), ("published", "published")], _mesh_axis(MESHES)))
def test_param_placements_equal_the_references(arch, which, shape):
    """Every family's inference placements (the hybrid's and the
    recurrent mixers' per-layer 1-D leaves on their last dim, the
    generic 2-D rule of the stacked reference leaf), and the training
    placements but for the stacked period axis of a per-layer 1-D leaf
    (replicated over "data" in the port)."""
    jcfg, tcfg = _configs(arch, which)
    jplan = jsharding.plan_for_mesh(JAbstractMesh(shape, ("data", "model")))
    plan = plan_for_mesh(AbstractMesh(shape, ("data", "model")))
    shapes = jax.eval_shape(lambda: jinit_model(jax.random.PRNGKey(0), jcfg))
    model = Transformer(tcfg, device="meta")
    params = dict(model.named_parameters())
    ref = jsharding.param_shardings(shapes, jplan, inference=True)
    got = param_specs(model, tcfg, plan, inference=True)
    placed = param_shardings(model, tcfg, plan, inference=True)
    sharded = 0
    for name, path, period in reference_layout(model, tcfg):
        want = tuple(_ref_leaf(ref, path).spec)
        want = want + (None,) * (len(_ref_leaf(shapes, path).shape)
                                 - len(want))
        if period is not None:
            assert want[0] is None     # serving never shards a period
            want = want[1:]
        assert got[name] == want, (name, got[name], want)
        sharded += any(a is not None for a in want)
        for ax, pl in zip(plan.mesh.mesh_dim_names, placed[name]):
            dims = [d for d, a in enumerate(want) if a == ax]
            assert (pl.is_shard(dims[0]) if dims
                    else pl.is_replicate()), (name, ax, pl)
    if arch == "qwen2-72b":
        assert sharded == len(got) - 1     # all but the final norm
    assert sharded >= len(got) // 2
    # the training placements: the reference's spec with its FSDP axis,
    # a per-layer 1-D leaf (a norm scale, a mixer's bias or decay)
    # replicated over "data" (its stacked period axis, which the
    # reference shards there, is the one exception)
    train = jsharding.param_shardings(shapes, jplan)
    got = param_specs(model, tcfg, plan)
    for name, path, period in reference_layout(model, tcfg):
        want = tuple(_ref_leaf(train, path).spec)
        want = want + (None,) * (len(_ref_leaf(shapes, path).shape)
                                 - len(want))
        if period is not None:
            assert want[0] is None or params[name].dim() == 1, name
            want = want[1:]
        assert got[name] == want, (name, got[name], want)


@pytest.mark.parametrize("arch,kv_bits,shape", _family_cases(
    [("8", 8), ("4", 4)], _mesh_axis(MESHES + [(1, 4)])))
def test_pool_placements_equal_the_references(arch, kv_bits, shape):
    """Each layer's paged pool (KV heads over "model" where the axis
    divides them, else whole: (1, 4) on the smoke configs' 2 KV heads),
    its replicated page scales and a recurrent layer's replicated
    states, against the reference's stacked leaf of the same layer."""
    jcfg, tcfg = _configs(arch, "smoke")
    jplan = jsharding.plan_for_mesh(JAbstractMesh(shape, ("data", "model")))
    plan = plan_for_mesh(AbstractMesh(shape, ("data", "model")))
    names = jnames(jcfg)
    jquant = jbuild(JPolicy.uniform(names, None, JFmt(2, kv_bits - 2)),
                    jcfg, quantize_kv=True, quantize_activations=False,
                    kv_container="int4" if kv_bits == 4 else "int8")
    jcaches = jax.eval_shape(lambda: jinit_cache(
        jcfg, 2, 32, jquant, paged=JPagedSpec(page_size=8, num_pages=9)))
    ref = jsharding.paged_pool_shardings(jcaches, jplan)
    tquant = build_model_quant(
        PrecisionPolicy.uniform(transformer_layer_names(tcfg), None,
                                FixedPointFormat(2, kv_bits - 2)),
        tcfg, quantize_kv=True, quantize_activations=False,
        kv_container="int4" if kv_bits == 4 else "int8")
    caches = init_cache(tcfg, tquant, PagedCacheSpec(page_size=8,
                                                     num_pages=9), "meta",
                        batch=2)
    got = paged_pool_specs(caches, plan)
    placed = paged_pool_shardings(caches, plan)
    model_ax = plan.mesh.mesh_dim_names.index("model")
    pools = 0
    # the reference stacks each segment's layers on a leading axis
    for li, si, j, _ in segment_layers(tcfg):
        for key, spec in got[li].items():
            ndim = len(jcaches[si][j][key].shape)
            want = tuple(ref[si][j][key].spec)
            want = want + (None,) * (ndim - len(want))
            assert want[0] is None, (li, key, want)
            assert spec == want[1:], (li, key, spec, want)
            sharded = "model" in spec
            assert placed[li][key][model_ax].is_shard(2) == sharded
            if key in ("k_pages", "v_pages"):
                pools += key == "k_pages"
                assert sharded == (tcfg.num_kv_heads % shape[1] == 0)
            else:
                assert not sharded, (li, key)
    assert pools == sum(k == "attn" for k, _ in layer_signatures(tcfg))


# ---------------------------------------------------------------------------
# The traps, on two gloo ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trap_runs():
    return tmesh.spawn_ranks(ranks.traps, 2, device="cpu")


def test_page_scale_and_argmax_traps_on_two_ranks(trap_runs):
    out = trap_runs
    for rank, res in enumerate(out):
        for container in ("int8", "int4"):
            r = res[container]
            assert r["scales_equal"] and r["pages_equal"], (rank, container)
        assert res["argmax"] == res["want"] == [3, 9, 13]
        # a pool without its KV-head mark under a plan is refused
        assert "not marked as a KV-head shard" in res["unmarked"]
    # the trap is real: rank 0's shard alone scales its pages lower
    assert not out[0]["int8"]["alone_scales_equal"]
    assert out[1]["shard_argmax"][0] == 11     # a per-shard argmax is wrong


def test_predictor_reads_the_first_ranks_clock_on_every_rank(trap_runs):
    """Each rank's wall clock reads a different TPOT slowdown; every rank
    consults the predictor with rank 0's, so all admit alike, and the
    run equals a tp = 1 run whose clock reads as rank 0's."""
    r0, r1 = (res["predictor"]["tp2"] for res in trap_runs)
    one = trap_runs[0]["predictor"]["tp1"]
    assert len(r0["features"]) >= 3
    assert r0["features"] == r1["features"] == one["features"]
    assert {f[-1] for f in r0["features"]} == {-0.2}
    assert r0["counters"] == r1["counters"] == one["counters"]
    assert r0["counters"]["sched.predictor_updates"] >= 1
    assert r0["tokens"] == r1["tokens"]
    gate = accuracy_gate(one["tokens"], r0["tokens"], **GATE)
    assert gate["passed"], gate


def test_host_and_test_meshes(trap_runs):
    """Over a running group of 2 ranks, and alone (no group: a one-rank
    gloo group is opened, and a mesh of more ranks is refused first)."""
    for res in trap_runs:
        m = res["meshes"]
        assert m["host"] == ((2,), ("data",))
        assert m["test"] == ((1, 2), ("data", "model"))
        assert m["test_default"] == ("mesh (2, 4) needs 8 ranks; the "
                                     "running group has 2")
    code = (
        "import torch.distributed as dist\n"
        "from repro_torch.launch import mesh\n"
        "try:\n"
        "    mesh.make_test_mesh((1, 2))\n"
        "except ValueError as e:\n"
        "    print(e, dist.is_initialized())\n"
        "m = mesh.make_test_mesh((1, 1))\n"
        "print(tuple(m.shape), m.mesh_dim_names, dist.get_backend())\n"
        "h = mesh.make_host_mesh(device='cpu')\n"
        "print(tuple(h.shape), h.mesh_dim_names)\n"
        "mesh.close_process_group()\n")
    env = dict(os.environ,
               PYTHONPATH=str(pathlib.Path(tserve.__file__).parents[2]))
    got = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert got.stdout.splitlines() == [
        "mesh (1, 2) needs 2 ranks; the running group has 1 False",
        "(1, 1) ('data', 'model') gloo",
        "(1,) ('data',)"]


# ---------------------------------------------------------------------------
# tp = 2 against tp = 1 and against the reference
# ---------------------------------------------------------------------------
# a pool small enough that cached prefixes demote to the host tier and
# come back (8 demotions, 2 promotions at tp = 1)
_BASE = dict(batch_size=2, max_len=48, page_size=8, num_pages=6,
             prefix_cache="on", kv_offload="host")
CASES = {
    "kv8-static-gather": dict(kv_bits=8, attn_impl="gather"),
    "kv8-page-kernel": dict(kv_bits=8, kv_scale="page", attn_impl="kernel"),
    "kv4-static-kernel": dict(kv_bits=4, attn_impl="kernel"),
    "kv4-page-gather": dict(kv_bits=4, kv_scale="page", attn_impl="gather"),
}


def _requests(vocab):
    """Pairs of requests over two alternating 16-token system prompts."""
    rng = np.random.default_rng(3)
    pre = [rng.integers(0, vocab, 16).tolist() for _ in range(2)]
    return [(i, pre[(i // 2) % 2] + rng.integers(0, vocab, 3 + i % 3).tolist(),
             6) for i in range(6)]


class _JTap:
    """Records the reference server's step logits, as ``DecodeTap``."""

    def __init__(self, srv):
        self.srv, self.fn, self.logits = srv, srv.decode, {}

    def __call__(self, params, tokens, pos, caches, pt):
        live = [(i, r) for i, r in enumerate(self.srv.slots) if r is not None]
        nxt, logits, caches = self.fn(params, tokens, pos, caches, pt)
        arr = np.asarray(logits)
        for i, r in live:
            self.logits[(r.rid, self.srv.slot_gen[i])] = arr[i]
        return nxt, logits, caches


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    jcfg, jparams = reference_params()
    cfg, model = reference_model()
    reqs = _requests(cfg.vocab_size)
    ref, one = {}, {}
    for name, kw in CASES.items():
        jkw = dict(_BASE, **dict(kw, attn_impl="gather"))
        jsrv = JServer(jcfg, jparams, **jkw)
        tap = _JTap(jsrv)
        jsrv.decode = tap
        done = jsrv.run([JRequest(r, np.asarray(p, np.int32), m)
                         for r, p, m in reqs])
        ref[name] = {"tokens": [list(r.out) for r in done],
                     "logits": tap.logits,
                     "counters": ranks.host_counters(jsrv)}
        forced = {r.rid: list(r.out) for r in done}
        toks, logits, counters, srv = ranks.serve_case(
            cfg, model, dict(_BASE, **kw), reqs, forced)
        one[name] = {"tokens": toks, "logits": logits, "counters": counters,
                     "forced": forced}
    path = tmp_path_factory.mktemp("tp") / "model.pt"
    torch.save(model.state_dict(), path)
    two = tmesh.spawn_ranks(
        ranks.serve_tp, 2, cfg, str(path),
        {n: dict(_BASE, **kw) for n, kw in CASES.items()}, reqs,
        {n: one[n]["forced"] for n in CASES}, device="cpu")
    return cfg, ref, one, two


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_step_logits_and_tokens(tp_runs, name):
    _, ref, one, two = tp_runs
    got = two[0][name]
    assert set(got["logits"]) == set(one[name]["logits"]) \
        == set(ref[name]["logits"])
    worst = {"tp1": 0.0, "ref": 0.0}
    for key, lg in got["logits"].items():
        worst["tp1"] = max(worst["tp1"],
                           float(np.abs(lg - one[name]["logits"][key]).max()))
        worst["ref"] = max(worst["ref"],
                           float(np.abs(lg - ref[name]["logits"][key]).max()))
    print(f"[tp2] {name}: {len(got['logits'])} step logits, max |diff| "
          f"{worst}; pager {got['counters'].get('pager.demotions')} "
          f"demotions / {got['counters'].get('pager.promotions')} "
          f"promotions")
    assert max(worst.values()) < 1e-4, worst
    # teacher-forced: each step's choice given the reference's history
    for want in (one[name]["tokens"], ref[name]["tokens"]):
        gate = accuracy_gate(want, got["tokens"], **GATE)
        assert gate["passed"], gate
    assert got["tokens"] == two[1][name]["tokens"]


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_counters_scales_and_shards(tp_runs, name):
    cfg, ref, one, two = tp_runs
    r0, r1 = two[0][name], two[1][name]
    assert r0["counters"] == r1["counters"] == one[name]["counters"]
    shared = set(ref[name]["counters"]) & set(one[name]["counters"])
    assert len(shared) > 20
    assert {k: one[name]["counters"][k] for k in shared} == \
        {k: ref[name]["counters"][k] for k in shared}
    # the replicated page scales stay equal on both ranks, bit for bit
    for a, b in zip(r0["scales"], r1["scales"]):
        np.testing.assert_array_equal(a, b)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert r0["pool"][2] == KV // 2
    w = r0["weights"]
    assert w["layers.0.attn.wq"] == (cfg.d_model, H // 2 * hd)
    assert w["layers.0.attn.wo"] == (H // 2 * hd, cfg.d_model)
    assert w["layers.0.mlp.w_down"] == (cfg.d_ff // 2, cfg.d_model)
    assert w["embed"] == (cfg.vocab_size, cfg.d_model // 2)
    assert w["head"] == (cfg.d_model, cfg.vocab_size // 2)
    assert r0["counters"]["pager.promotions"] >= 1
    assert r0["round_trip"] and r1["round_trip"]
    assert r0["blob_heads"][-2] == KV // 2
    if name == "kv8-page-kernel":
        assert r0["namespaces_differ"] and r0["published"] >= 1
        assert r0["installed_into_tp1"] == 0


# ---------------------------------------------------------------------------
# Refusals and the CLI
# ---------------------------------------------------------------------------
def test_serving_mesh_refusals_in_the_references_words():
    for tp in (0, 3):
        with pytest.raises(ValueError) as want:
            jmesh(tp)
        with pytest.raises(ValueError) as got:
            tmesh.make_serving_mesh(tp, device="cpu")
        assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError,
                       match="queue A item 13 part 5"):
        tmesh.make_production_mesh()
    # the training half's placements are ported (part 3): they lay out a
    # batch, a dense cache and a train state on a 2 x 2 mesh
    plan = plan_for_mesh(AbstractMesh((2, 2), ("data", "model")))
    batch = {"tokens": torch.zeros(4, 8, dtype=torch.int32)}
    assert parallel.auto_batch_sharding(batch, plan)["tokens"][0].is_shard(0)
    cache = [{"k": torch.zeros(2, 8, 2, 4), "v": torch.zeros(2, 8, 2, 4)}]
    k_data, k_model = parallel.cache_shardings(cache, plan)[0]["k"]
    assert k_data.is_shard(0) and k_model.is_shard(2)
    from repro_torch.launch.steps import _meta_state
    tcfg = _configs("qwen2-72b", "smoke")[1]
    state = _meta_state(tcfg, int8=True, residual=True)
    placed = parallel.sharding.state_shardings(state, tcfg, plan)
    assert placed["opt"]["m"]["embed"]["q"] == placed["params"]["embed"]
    import repro.parallel
    assert parallel.__all__ == repro.parallel.__all__


def test_mesh_keeps_the_references_refusals():
    """What ``mesh=`` still refuses is what the reference refuses, in its
    words: an MLA model's paged pool, and an encoder at the CLI, ``--tp``
    included (before any rank starts)."""
    from repro.launch import serve as jserve
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models.transformer import init_model
    arch = "deepseek-v3-671b"
    with pytest.raises(NotImplementedError) as want:
        JServer(jsmoke(arch), None, batch_size=2, max_len=32, page_size=8)
    cfg = get_smoke_config(arch)
    model = init_model(cfg, seed=0, device=CPU)
    with pytest.raises(NotImplementedError) as got:
        tserve.BatchedServer(cfg, model, batch_size=2, max_len=32,
                             page_size=8, kv_bits=8, device=CPU,
                             mesh=AbstractMesh((1, 2), ("data", "model")))
    assert str(got.value) == str(want.value) \
        == "paged KV serving supports GQA archs"
    argv = ["--arch", "hubert-xlarge", "--smoke", "--page-size", "8"]
    with pytest.raises(SystemExit) as want:
        jserve.main(argv + ["--tp", "2"])
    for extra in ([], ["--tp", "2"]):
        with pytest.raises(SystemExit) as got:
            tserve.main(argv + ["--device", "cpu"] + extra)
        assert str(got.value) == str(want.value) \
            == "encoder-only archs have no decode path"
    # no refusal names part 4b: the other families serve under mesh=
    import repro_torch
    root = pathlib.Path(repro_torch.__file__).parent
    assert not [f for f in root.rglob("*.py")
                if "13 part 4b" in f.read_text()]


def test_cli_tp2_on_gloo(capsys):
    argv = ["--arch", "qwen2-72b", "--smoke", "--device", "cpu",
            "--requests", "4", "--batch-size", "2", "--max-new", "5",
            "--max-len", "48", "--page-size", "8", "--kv-bits", "8",
            "--prefix-cache", "on"]
    one = tserve.main(argv)
    two = tserve.main(argv + ["--tp", "2"])
    assert [r.rid for r in two] == [r.rid for r in one]
    assert all(r.done for r in two)
    gate = accuracy_gate([r.out for r in one], [r.out for r in two], **GATE)
    assert gate["passed"], gate


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_cli_tp2_serves_the_recurrent_families_on_gloo(arch):
    """``--tp 2`` on the recurrent families (their mixers whole on each
    rank, the output projection row-parallel): every request finishes,
    and the tokens pass the gate against ``--tp 1``'s."""
    argv = ["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
            "--batch-size", "2", "--max-new", "4", "--max-len", "32",
            "--prompt-len", "6", "--page-size", "8", "--kv-bits", "8"]
    one = tserve.main(argv)
    two = tserve.main(argv + ["--tp", "2"])
    assert [r.rid for r in two] == [r.rid for r in one]
    assert all(r.done for r in two)
    gate = accuracy_gate([r.out for r in one], [r.out for r in two], **GATE)
    assert gate["passed"], gate
