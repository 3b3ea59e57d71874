"""Port parity of the op-level cost recorder (``repro_torch.launch.
hlo_cost`` and ``hlo_analysis``) against the reference's loop-aware HLO
cost model (``repro.launch.hlo_cost``), on the programs of
``tests/test_hlo_cost.py``: each JAX program compiled and analyzed by the
reference, its eager twin recorded by the port, in the same test.

* a 12-trip loop's FLOPs, a nested 3 x 5 loop's FLOPs and loop trips, a
  dot's FLOPs over its contracting dims: equal;
* one row sliced a step: priced at the slice (under 10 x 4nd bytes);
* ``torch.cond`` priced at its dearer branch, whichever is taken;
* the ring factors: the reference's table;
* all-gather, all-reduce and all-to-all on a fake group of 4 ranks: the
  per-type summary equals the reference's ``collective_summary`` of a
  ``shard_map`` program of the same three collectives on 4 virtual
  devices (in a subprocess: the device count is fixed at JAX's start);
* the memory: a storage counted once across its views and freed with
  its last reference, autograd's saved tensors live until the backward.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo_analysis as jana
from repro.launch.hlo_cost import analyze as janalyze
from repro_torch.launch import hlo_analysis as tana
from repro_torch.launch.hlo_cost import OpCostRecorder, analyze
from repro_torch.launch.mesh import fake_group

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax(f, *specs, loops=False):
    return janalyze(jax.jit(f).lower(*specs).compile().as_text(),
                    loops=loops)


def _record(fn, *args, loops=False):
    rec = OpCostRecorder()
    with rec:
        fn(rec, *args)
    return analyze(rec, loops=loops), rec


def test_loop_flops_count_every_trip():
    def f(x):
        def body(c, _):
            return c @ x + 1.0, None
        y, _ = jax.lax.scan(body, jnp.ones((8, 8)), None, length=12)
        return y

    def g(rec, x):
        c = torch.ones(8, 8)
        with rec.loop("scan", 12):
            for _ in range(12):
                c = c @ x + 1.0

    want = _jax(f, jax.ShapeDtypeStruct((8, 8), jnp.float32))
    got, _ = _record(g, torch.randn(8, 8))
    assert got["flops"] == want["flops"] == 12 * 2 * 8 * 8 * 8


def test_nested_loop_trips_multiply():
    def f(x):
        def outer(c, _):
            def inner(ci, _):
                return ci @ x, None
            ci, _ = jax.lax.scan(inner, c, None, length=5)
            return ci, None
        y, _ = jax.lax.scan(outer, jnp.ones((4, 4)), None, length=3)
        return y

    def g(rec, x):
        c = torch.ones(4, 4)
        with rec.loop("outer", 3):
            for _ in range(3):
                with rec.loop("inner", 5):
                    for _ in range(5):
                        c = c @ x

    want = _jax(f, jax.ShapeDtypeStruct((4, 4), jnp.float32), loops=True)
    got, _ = _record(g, torch.randn(4, 4), loops=True)
    assert got["flops"] == want["flops"] == 3 * 5 * 2 * 4 * 4 * 4
    trips = sorted(lp["trip"] for lp in got["loops"])
    assert trips == sorted(lp["trip"] for lp in want["loops"]) == [3, 5]
    inner = next(lp for lp in got["loops"] if lp["name"] == "inner")
    assert inner["in"] == "outer" and inner["body_flops"] == 2 * 4 ** 3


def test_row_slice_priced_at_the_slice():
    n, d = 64, 1024

    def f(xs):
        def body(c, x_t):
            return c + x_t.sum(), None
        out, _ = jax.lax.scan(body, jnp.float32(0), xs)
        return out

    def g(rec, xs):
        c = torch.zeros(())
        with rec.loop("scan", n):
            for t in range(n):
                c = c + xs[t].sum()

    want = _jax(f, jax.ShapeDtypeStruct((n, d), jnp.float32))
    got, _ = _record(g, torch.randn(n, d))
    assert want["hbm_bytes"] < 10 * 4 * n * d
    assert got["hbm_bytes"] < 10 * 4 * n * d
    # one pass over xs, plus the carries
    assert got["hbm_bytes"] >= 4 * n * d


def test_dot_flops_use_contracting_dims():
    want = _jax(lambda a, b: a @ b,
                jax.ShapeDtypeStruct((32, 128), jnp.float32),
                jax.ShapeDtypeStruct((128, 16), jnp.float32))
    got, _ = _record(lambda rec, a, b: a @ b, torch.randn(32, 128),
                     torch.randn(128, 16))
    assert got["flops"] == want["flops"] == 2 * 32 * 16 * 128


@pytest.mark.parametrize("taken", [True, False])
def test_cond_prices_the_dearer_branch(taken):
    def f(p, x):
        return jax.lax.cond(p, lambda x: (x @ x) @ x, lambda x: x, x)

    want = _jax(f, jax.ShapeDtypeStruct((), jnp.bool_),
                jax.ShapeDtypeStruct((16, 16), jnp.float32))
    x = torch.randn(16, 16)
    out = {}

    def g(rec, p, x):
        out["y"] = torch.cond(p, lambda x: (x @ x) @ x,
                              lambda x: x.clone(), (x,))

    got, _ = _record(g, torch.tensor(taken), x)
    assert want["flops"] >= 2 * 2 * 16 ** 3
    assert got["flops"] == 2 * 2 * 16 ** 3
    # the value is the branch taken
    ref = (x @ x) @ x if taken else x
    torch.testing.assert_close(out["y"], ref)


def test_ring_factors_are_the_references():
    assert tana.COLLECTIVE_OPS == jana.COLLECTIVE_OPS
    for op in jana.COLLECTIVE_OPS:
        for g in (1, 2, 4, 16, 512):
            assert tana._RING_FACTOR[op](g) == jana._RING_FACTOR[op](g)


_SHARD_MAP = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json, warnings
warnings.filterwarnings("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.launch.hlo_analysis import collective_summary
mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
def body(x):
    g = jax.lax.all_gather(x, "d", tiled=True)
    r = jax.lax.psum(x * 2.0, "d")
    a = jax.lax.all_to_all(x * 3.0, "d", 0, 0, tiled=True)
    return g[:8] + r + a
f = jax.jit(shard_map(body, mesh=mesh, in_specs=P("d"), out_specs=P("d"),
                      check_rep=False))
txt = f.lower(jax.ShapeDtypeStruct((32, 16), jnp.float32)).compile().as_text()
print(json.dumps(collective_summary(txt)))
"""


def test_collectives_on_a_fake_group_are_the_references():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    got = subprocess.run([sys.executable, "-c", textwrap.dedent(_SHARD_MAP)],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-3000:]
    want = json.loads(got.stdout.strip().splitlines()[-1])
    from torch._subclasses.fake_tensor import FakeTensorMode
    with fake_group(4), FakeTensorMode():
        x = torch.empty(8, 16)
        rec = OpCostRecorder()
        with rec:
            parts = [torch.empty_like(x) for _ in range(4)]
            dist.all_gather(parts, x)
            dist.all_reduce(x * 2.0)
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x * 3.0)
    assert not dist.is_initialized()
    summary = tana.collective_summary(rec.collectives)
    assert summary == want
    res = analyze(rec)
    assert res["wire_bytes"] == want["total_wire_bytes_per_device"]
    assert res["collectives"] == {k: v["wire_bytes"]
                                  for k, v in want["per_type"].items()}


def test_memory_counts_storages_once_and_frees_them():
    x = torch.randn(256, 256, requires_grad=True)     # 256 KiB
    rec = OpCostRecorder()
    rec.track(x)
    with rec:
        y = torch.tanh(x)               # saved for the backward
        v = y.view(-1)[:10]             # a view: no new storage
        assert rec.live_bytes == 2 * 256 * 256 * 4
        z = (y * 2.0).sum()
        del v
        z.backward()
        del y, z
    rec.outputs(x.grad)
    mem = tana.memory_summary(rec)
    assert mem["argument_size_in_bytes"] == 256 * 256 * 4
    assert mem["output_size_in_bytes"] == 256 * 256 * 4     # the gradient
    # x, tanh(x) and y * 2 live together at the peak
    assert mem["peak_memory_in_bytes"] >= 3 * 256 * 256 * 4
    assert mem["peak_memory_in_bytes"] <= 5 * 256 * 256 * 4 + 64
    # after the step: the argument and its gradient
    assert rec.live_bytes == 2 * 256 * 256 * 4
