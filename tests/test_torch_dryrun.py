"""Port parity of the dry run (``repro_torch.launch.dryrun``), the
production mesh and the decode input specs against the reference.

* ``make_production_mesh`` over fake groups of 256 and 512 ranks has the
  reference's shapes and axes, and refuses any other group, or none, in
  words that name the sizes; ``fake_group`` leaves no group behind.
* ``decode_specs`` / ``input_specs`` give the reference's keys, shapes
  and dtypes for every arch x applicable shape (its caches stacked on a
  leading period axis, the port's per layer: ``segment_layers``).
* The reference's dry-run test list (qwen1.5-32b, deepseek-v3-671b,
  xlstm-350m and jamba-v0.1-52b smoke; train, and decode at kv_bits 8;
  seq 128, batch 8) lays out on a fake (2, 2, 2) pod x data x model
  mesh with no kernel wrapper reached: per-rank argument bytes equal the
  per-device bytes of the reference's own ``state_shardings`` /
  ``param_shardings`` / ``cache_shardings`` / ``auto_batch_sharding`` on
  8 virtual devices (a subprocess), apart from the known differences,
  counted by name: a per-layer 1-D leaf, whose stacked period axis the
  reference shards over "data", is replicated over "data"; a cache leaf
  the port's mixers read whole (a recurrent state, an MLA latent, K/V
  whose heads "model" does not divide) is whole over "model"; the
  decode position is a host int.
* A dense train cell's per-rank FLOPs equal ``FlopCounterMode`` of the
  plain step on the rank's B / 4 rows.
* On a one-rank gloo mesh a real-tensor cell (train, decode) is the plain
  step bit for bit.
* Each record's ``model`` block equals the reference's ``run_cell``'s for
  every arch x shape (the reference's run in a subprocess with its
  ``lower_cell`` and ``make_production_mesh`` stubbed, so nothing
  compiles), and the port's record carries every key of the
  reference's.
* After a dry run, a real forward in the same process still runs (no
  fake tensor left in a module cache).
"""
import dataclasses
import math
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import shapes as jshapes
from repro.configs.registry import get_config as jget_config
from repro.core.fixedpoint import FixedPointFormat as JFormat
from repro.core.policy import PrecisionPolicy as JPolicy
from repro.quant.apply import build_model_quant as jbuild_quant
from repro.quant.apply import transformer_layer_names as jlayer_names
from repro_torch.configs import shapes as tshapes
from repro_torch.configs.counting import segment_layers
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.hlo_cost import OpCostRecorder
from repro_torch.launch.steps import TrainHParams, make_decode_step, \
    make_train_step
from repro_torch.models.transformer import init_model
from repro_torch.optim.adamw import AdamWConfig

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-32b", "deepseek-v3-671b", "xlstm-350m", "jamba-v0.1-52b")
TRAIN = ShapeConfig("t", 128, 8, "train")
DECODE = ShapeConfig("d", 128, 8, "decode")
MESH = (2, 2, 2)
AXES = ("pod", "data", "model")


def _cfg(arch):
    return dataclasses.replace(get_smoke_config(arch), loss_chunk=64)


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the reference, in a subprocess: shardings on 8 virtual devices and its
# run_cell's model blocks with nothing compiled
# ---------------------------------------------------------------------------
_REFERENCE = """
import os, pickle, sys, dataclasses, math
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import warnings; warnings.filterwarnings("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.launch import dryrun
from repro.configs.registry import ARCH_IDS, get_smoke_config
from repro.configs.shapes import SHAPES, ShapeConfig, input_specs, decode_specs
from repro.launch.steps import TrainHParams, init_train_state
from repro.models.transformer import init_model
from repro.optim.adamw import AdamWConfig
from repro.parallel.sharding import (plan_for_mesh, state_shardings,
                                     param_shardings, cache_shardings,
                                     auto_batch_sharding)

class _Stub:
    def compile(self):
        return self
    def memory_analysis(self):
        return None
    def cost_analysis(self):
        return None
    def as_text(self):
        return ""

class _Mesh:
    def __init__(self, multi):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi
                      else {"data": 16, "model": 16})

dryrun.lower_cell = lambda *a, **k: _Stub()
dryrun.make_production_mesh = lambda multi_pod=False: _Mesh(multi_pod)
out = {"records": {}, "bytes": {}}
for arch in ARCH_IDS:
    for shape in SHAPES:
        out["records"][(arch, shape)] = dryrun.run_cell(arch, shape, "single")

mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
            ("pod", "data", "model"))
plan = plan_for_mesh(mesh)

def leaves(tree, shardings, prefix):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sh = jax.tree_util.tree_leaves(shardings)
    res = []
    for (path, leaf), s in zip(flat, sh):
        spec = tuple(s.spec) + (None,) * (len(leaf.shape) - len(s.spec))
        res.append((prefix + jax.tree_util.keystr(path), tuple(leaf.shape),
                    jnp.dtype(leaf.dtype).itemsize,
                    tuple(tuple(e) if isinstance(e, tuple) else e
                          for e in spec)))
    return res

tr = ShapeConfig("t", 128, 8, "train")
dc = ShapeConfig("d", 128, 8, "decode")
for arch in sys.argv[1].split(","):
    cfg = dataclasses.replace(get_smoke_config(arch), loss_chunk=64)
    hp = TrainHParams(adamw=AdamWConfig(quantize_moments=True))
    st = jax.eval_shape(lambda k: init_train_state(k, cfg, hp),
                        jax.random.PRNGKey(0))
    b = input_specs(cfg, tr)
    out["bytes"][(arch, "train")] = (
        leaves(st, state_shardings(st, plan), "state")
        + leaves(b, auto_batch_sharding(b, plan), "batch"))
    quant = dryrun.make_quant(cfg, 8)
    pr = jax.eval_shape(lambda k: init_model(k, cfg), jax.random.PRNGKey(0))
    sp = decode_specs(cfg, dc, quant=quant)
    tok = {"t": sp.get("tokens", sp.get("embeds"))}
    out["bytes"][(arch, "decode")] = (
        leaves(pr, param_shardings(pr, plan), "params")
        + leaves(sp["caches"], cache_shardings(sp["caches"], plan, lead=1),
                 "caches")
        + leaves(tok, auto_batch_sharding(tok, plan), "tokens")
        + [("pos", (), 4, ())])
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Started first, so that it runs beside the port's lay-outs."""
    d = tmp_path_factory.mktemp("dryrun_ref")
    script, dst = d / "ref.py", d / "ref.pkl"
    script.write_text(textwrap.dedent(_REFERENCE))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(script), ",".join(ARCHS),
                             str(dst)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with open(dst, "rb") as f:
            return pickle.load(f)

    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# the lay-outs, every kernel wrapper made to raise
# ---------------------------------------------------------------------------
def _kernel_wrappers():
    from repro_torch.kernels import (pack, paged_kv_attention, quant_cast,
                                     quant_matmul)
    from repro_torch.models import attention
    return [(pack, "pack_2d"), (pack, "unpack_2d"),
            (quant_cast, "quant_cast"), (quant_matmul, "quant_matmul"),
            (paged_kv_attention, "paged_kv_attention_chunk"),
            (attention, "paged_kv_attention_chunk")]


@pytest.fixture(scope="module")
def cells(reference):
    mp = pytest.MonkeyPatch()
    reached = []
    for mod, name in _kernel_wrappers():
        mp.setattr(mod, name, lambda *a, _n=name, **k: reached.append(_n))
    try:
        out = {}
        with tmesh.fake_group(8):
            mesh = tmesh.make_test_mesh(MESH, AXES)
            for arch in ARCHS:
                for shape in (TRAIN, DECODE):
                    out[(arch, shape.kind)] = dryrun.lower_cell(
                        _cfg(arch), shape, mesh,
                        kv_bits=8 if shape.kind == "decode" else 0)
    finally:
        mp.undo()
    assert reached == []
    return out


# ---------------------------------------------------------------------------
# the production mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("multi", [False, True])
def test_production_mesh_over_the_fake_group(multi):
    n = 512 if multi else 256
    with tmesh.fake_group(n):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        want = jax.sharding.AbstractMesh(
            (2, 16, 16) if multi else (16, 16),
            ("pod", "data", "model") if multi else ("data", "model"))
        assert tuple(mesh.shape) == tuple(want.axis_sizes)
        assert tuple(mesh.mesh_dim_names) == tuple(want.axis_names)
        with pytest.raises(ValueError, match=f"exactly {1024 // n * 128} "
                           f"ranks.*the running group has {n}"):
            tmesh.make_production_mesh(multi_pod=not multi)
        with pytest.raises(RuntimeError, match="running already"):
            with tmesh.fake_group(8):
                pass


def test_production_mesh_refuses_without_a_group():
    with pytest.raises(ValueError) as got:
        tmesh.make_production_mesh()
    msg = str(got.value)
    assert "exactly 256 ranks (256 single-pod, 512 multi-pod)" in msg
    assert "no group is running" in msg
    with tmesh.fake_group(8):
        with pytest.raises(ValueError, match="exactly 512 ranks.*the running "
                           "group has 8"):
            tmesh.make_production_mesh(multi_pod=True)


# ---------------------------------------------------------------------------
# the decode input specs
# ---------------------------------------------------------------------------
def _jquant(jcfg, bits):
    pol = JPolicy.uniform(jlayer_names(jcfg), None, JFormat(2, bits - 2))
    return jbuild_quant(pol, jcfg, quantize_kv=True,
                        quantize_activations=False, kv_container="int8")


def _dt(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else jnp.dtype(d).name


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_are_the_references(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in SHAPES.values():
        if not tshapes.applicable(cfg, shape):
            continue
        jshape = jshapes.SHAPES[shape.name]
        for bits in ((0, 8) if shape.kind == "decode" else (0,)):
            jq = _jquant(jcfg, bits) if bits else None
            tq = dryrun.make_quant(cfg, bits)
            want = jshapes.input_specs(jcfg, jshape, quant=jq)
            got = tshapes.input_specs(cfg, shape, quant=tq)
            assert set(got) == set(want)
            for k in want:
                if k == "caches":
                    continue
                assert got[k] == (tuple(want[k].shape), got[k][1])
                assert _dt(got[k][1]) == _dt(want[k].dtype), k
            if shape.kind != "decode":
                continue
            caches = got["caches"]
            assert len(caches) == cfg.num_layers
            for li, si, j, _ in segment_layers(cfg):
                ref = want["caches"][si][j]
                assert set(caches[li]) == set(ref), (li, set(ref))
                for key, leaf in ref.items():
                    shp, dt = caches[li][key]
                    assert shp == tuple(leaf.shape[1:]), (li, key)
                    assert _dt(dt) == _dt(leaf.dtype), (li, key)


# ---------------------------------------------------------------------------
# the lay-outs against the reference's shardings
# ---------------------------------------------------------------------------
_SIZES = dict(zip(AXES, MESH))


def _axes(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _port_bytes(name, shape, itemsize, spec, kv_div):
    """The port's per-rank bytes of one reference leaf, and the known
    difference it shows (None: none)."""
    n = itemsize * math.prod(shape)
    for e in spec:
        n //= math.prod(_SIZES[a] for a in _axes(e))
    if name == "pos":
        return 0, "a host int"
    if name.startswith("caches"):
        key = name.rsplit("'", 2)[-2]
        whole = [d for d, e in enumerate(spec) if "model" in _axes(e)
                 and not (key in ("k", "v") and d == 3 and kv_div)]
        if whole:
            return n * _SIZES["model"], "a cache leaf read whole"
        return n, None
    if "['segments']" in name and _axes(spec[0]):
        # the stacked form of a per-layer 1-D leaf: (periods, D) or an int8
        # moment's (periods, 1) scale
        assert len(shape) == 2, name
        return n * math.prod(_SIZES[a] for a in _axes(spec[0])), \
            "a per-layer 1-D leaf"
    return n, None


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_are_the_references(arch, kind, cells, reference):
    cfg = _cfg(arch)
    kv_div = cfg.num_kv_heads % _SIZES["model"] == 0
    want, known = 0, {}
    for name, shape, itemsize, spec in reference()["bytes"][(arch, kind)]:
        n, why = _port_bytes(name, shape, itemsize, spec, kv_div)
        want += n
        if why:
            known.setdefault(why, []).append(name)
    assert cells[(arch, kind)].memory["argument"] == want, (arch, kind)
    # qwen1.5-32b- and xlstm-smoke stack 4 and 2 periods, which "data"
    # shards in the reference
    assert bool(known.get("a per-layer 1-D leaf")) == (
        arch in ("qwen1.5-32b", "xlstm-350m"))
    if kind == "decode":
        # the recurrent states, MLA's latent and unsplit K/V heads
        whole = {n.rsplit("'", 2)[-2] for n in known.get(
            "a cache leaf read whole", [])}
        kinds = {"k", "v"} if not kv_div else set()
        assert whole <= kinds | {"latent", "ssm", "conv", "C", "n", "m",
                                 "h", "c"}, whole
        assert known["a host int"] == ["pos"]


def test_dense_train_flops_are_the_plain_steps(cells):
    """qwen1.5-32b-smoke: the rank's B / 4 = 2 rows through the plain
    step, counted by ``FlopCounterMode``."""
    cfg = _cfg("qwen1.5-32b")
    hp = TrainHParams(adamw=AdamWConfig(quantize_moments=True))
    state = {"params": init_model(cfg, seed=0, device="cpu",
                                  trainable=True)}
    from repro_torch.launch.steps import init_train_state
    state = init_train_state(cfg, hp, model=state["params"])
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, TRAIN.seq_len),
                              generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, hp)(state, batch)
    assert cells[("qwen1.5-32b", "train")].total.flops == \
        fc.get_total_flops()


def _one_rank(fn):
    port = tmesh.free_port()
    tmesh.init_process_group(0, 1, port, "cpu")
    try:
        return fn(tmesh.make_test_mesh((1, 1), ("data", "model")))
    finally:
        tmesh.close_process_group()


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "jamba-v0.1-52b"])
def test_one_rank_cells_are_the_plain_steps(arch):
    cfg = _cfg(arch)
    shape = ShapeConfig("t", 32, 2, "train")
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 32), generator=g,
                              dtype=torch.int32) for k in ("tokens",
                                                           "labels")}
    hp = TrainHParams(adamw=AdamWConfig(quantize_moments=True))

    def cell(mesh):
        model = init_model(cfg, seed=0, device="cpu", trainable=True)
        run, _ = dryrun.build_cell(cfg, shape, mesh, model=model,
                                   inputs=batch)
        state, metrics = run()
        return state["params"], metrics

    got_model, got = _one_rank(cell)
    from repro_torch.launch.steps import init_train_state
    plain = init_train_state(cfg, hp, model=init_model(
        cfg, seed=0, device="cpu", trainable=True))
    _, want = make_train_step(cfg, hp)(plain, batch)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for (n, a), (_, b) in zip(got_model.named_parameters(),
                              plain["params"].named_parameters()):
        assert torch.equal(a, b), n

    dshape = ShapeConfig("d", 64, 2, "decode")
    tokens = {"tokens": torch.tensor([3, 7], dtype=torch.int32)}

    def dcell(mesh):
        run, _ = dryrun.build_cell(cfg, dshape, mesh, kv_bits=8,
                                   model=init_model(cfg, seed=0,
                                                    device="cpu"),
                                   inputs=tokens)
        return run()

    nxt, logits, caches = _one_rank(dcell)
    from repro_torch.models.transformer import init_cache
    quant = dryrun.make_quant(cfg, 8)
    ref_caches = init_cache(cfg, quant, None, "cpu", batch=2, max_len=64)
    wn, wl, wc = make_decode_step(cfg, quant=quant)(
        init_model(cfg, seed=0, device="cpu"), tokens["tokens"], 63,
        ref_caches, None)
    assert torch.equal(nxt, wn) and torch.equal(logits, wl)
    for a, b in zip(caches, wc):
        for k in b:
            assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------
def test_model_blocks_and_keys_are_the_references(reference, monkeypatch):
    ref = reference()["records"]
    monkeypatch.setattr(dryrun, "lower_cell",
                        lambda *a, **k: OpCostRecorder())

    class _Mesh:
        mesh_dim_names, shape = ("data", "model"), (16, 16)

    for arch in ARCH_IDS:
        for shape in SHAPES:
            got = dryrun.run_cell(arch, shape, "single", mesh=_Mesh())
            want = ref[(arch, shape)]
            if want.get("skipped"):
                assert got == want
                continue
            assert got["model"] == want["model"], (arch, shape)
            assert set(want) <= set(got), set(want) - set(got)
            assert got["mesh_shape"] == want["mesh_shape"]
            assert got["compile_s"] is None


def test_a_real_forward_runs_after_the_dry_run(cells):
    """The dry run's fake tensors stay out of the model's caches (the RoPE
    angles and M-RoPE bands): a real decode step runs in this process."""
    cfg = _cfg("qwen1.5-32b")
    model = init_model(cfg, seed=0, device="cpu")
    from repro_torch.models.transformer import init_cache
    caches = init_cache(cfg, None, None, "cpu", batch=1, max_len=8)
    nxt, logits, _ = make_decode_step(cfg)(
        model, torch.tensor([1], dtype=torch.int32), 0, caches, None)
    assert torch.isfinite(logits).all()


def test_a_fake_tensor_reaching_a_kernel_raises():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops
    with FakeTensorMode():
        x = torch.zeros(4, 8)
        with pytest.raises(RuntimeError, match="must not reach a kernel"):
            ops.quant_cast(x, 2, 6)
        with pytest.raises(RuntimeError, match="must not reach a kernel"):
            ops.pack(torch.zeros(2, 8, dtype=torch.int32), 8)
