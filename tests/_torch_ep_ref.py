"""The reference's expert-parallel functions on 4 virtual host devices,
for ``tests/test_torch_ep.py``:

    python tests/_torch_ep_ref.py IN.pkl OUT.pkl

It runs in a process of its own, since the virtual devices must be set
before JAX starts. The meshes are ``jax.sharding.Mesh``es with Auto axes:
this JAX's ``with_sharding_constraint`` refuses ``jax.make_mesh``'s
Explicit axes, which is why the reference's own sharded-step tests fail
here.

* ``dispatch``: ``moe_apply`` (scatter) under ``activation_hints`` on
  each mesh, for each case and wire width: the output, the load-balance
  loss, and at 0 bits the gradients of ``sum(y * cot)`` with respect to
  the MoE's parameters and ``x``; at 8 and 16 bits also the same
  dispatch with a straight-through wire (:func:`ste_moe_apply`), its
  output and gradients.
* ``train``: a config's ``train_loss`` and its gradients under each
  mesh's hints, three steps of the reference's train step there (its
  ``value_and_grad`` under the hints, then ``adamw_update``), and
  ``train_loss`` on a one-device mesh at ``moe_a2a_bits`` 8.
"""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import warnings  # noqa: E402

warnings.filterwarnings("ignore")

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental.shard_map import shard_map  # noqa: E402
from jax.sharding import Mesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import get_smoke_config  # noqa: E402
from repro.launch.steps import TrainHParams  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.models.mlp import swiglu_apply  # noqa: E402
from repro.optim.adamw import adamw_init, adamw_update  # noqa: E402
from repro.parallel.hints import activation_hints  # noqa: E402
from repro.parallel.sharding import plan_for_mesh  # noqa: E402


def make_plan(shape):
    devs = np.array(jax.devices()[:math.prod(shape)]).reshape(shape)
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return plan_for_mesh(Mesh(devs, axes))


def flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# the dispatch with a straight-through wire: the reference's
# _sharded_dispatch and _local_dispatch_ffn, the wire's quantize-dequantize
# given the identity's gradient
# ---------------------------------------------------------------------------
def _qdq(t, bits):
    qmax = 2.0 ** (bits - 1) - 1
    scale = jnp.max(jnp.abs(t), axis=-1, keepdims=True) \
        .astype(jnp.float32) / qmax
    scale = jnp.maximum(scale, 1e-12)
    q = jnp.clip(jnp.round(t.astype(jnp.float32) / scale), -qmax, qmax) \
        .astype(jnp.int8 if bits <= 8 else jnp.int16)
    return (q.astype(jnp.float32) * scale).astype(t.dtype)


_ste = jax.custom_vjp(_qdq, nondiff_argnums=(1,))
_ste.defvjp(lambda t, bits: (_qdq(t, bits), None), lambda bits, _, g: (g,))


def _ste_local(experts, x_loc, idx_loc, w_loc, cfg, ep_axes):
    T, D = x_loc.shape
    cd = x_loc.dtype
    E, k = cfg.num_experts, cfg.experts_per_token
    A = T * k
    C = max(1, int(np.ceil(T * k / E * cfg.moe_capacity_factor)))
    e_a = idx_loc.reshape(A)
    oh = jax.nn.one_hot(e_a, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0), e_a[:, None],
                              axis=1)[:, 0] - 1
    keep = pos < C
    pos_s = jnp.where(keep, pos, C - 1)
    x_a = jnp.repeat(x_loc, k, axis=0)
    buf = jnp.zeros((E, C, D), cd).at[e_a, pos_s].add(
        x_a * keep[:, None].astype(cd), mode="drop")

    def a2a(t, split, concat):
        return jax.lax.all_to_all(_ste(t, cfg.moe_a2a_bits), ep_axes,
                                  split_axis=split, concat_axis=concat,
                                  tiled=True)

    buf = a2a(buf, 0, 1)
    g = jnp.einsum("ecd,edf->ecf", buf, experts["w_gate"].astype(cd))
    u = jnp.einsum("ecd,edf->ecf", buf, experts["w_up"].astype(cd))
    h = jax.nn.silu(g.astype(jnp.float32)).astype(cd) * u
    y = jnp.einsum("ecf,efd->ecd", h, experts["w_down"].astype(cd))
    y = a2a(y, 1, 0)
    y_a = y[e_a, pos_s] * keep[:, None].astype(cd)
    return (y_a.reshape(T, k, D)
            * w_loc.reshape(T, k)[..., None].astype(cd)).sum(axis=1)


def ste_moe_apply(params, x, cfg, plan):
    """``moe_apply`` (scatter, under ``plan``) with a straight-through
    wire: the reference's forward, the identity's gradient through the
    quantize-dequantize."""
    B, S, D = x.shape
    w, idx, aux = jmoe._route(params, x, cfg)
    dp = plan.batch_axes if B % plan.batch_size_divisor == 0 else None
    if isinstance(dp, tuple) and len(dp) == 1:
        dp = dp[0]
    tp = plan.model_axis if S % plan.mesh.shape[plan.model_axis] == 0 \
        else None
    x_spec = P(dp, tp, None)
    fsdp = plan.fsdp_axis
    shard_f = fsdp is not None and cfg.moe_d_ff % plan.mesh.shape[fsdp] == 0
    f_ax = fsdp if shard_f else None
    ex_specs = {"w_gate": P(plan.model_axis, None, f_ax),
                "w_up": P(plan.model_axis, None, f_ax),
                "w_down": P(plan.model_axis, f_ax, None)}

    def body(ex, xl, il, wl):
        if shard_f:
            ex = {"w_gate": jax.lax.all_gather(ex["w_gate"], fsdp, axis=2,
                                               tiled=True),
                  "w_up": jax.lax.all_gather(ex["w_up"], fsdp, axis=2,
                                             tiled=True),
                  "w_down": jax.lax.all_gather(ex["w_down"], fsdp, axis=1,
                                               tiled=True)}
        Bl, Sl, _ = xl.shape
        out = _ste_local(ex, xl.reshape(Bl * Sl, D), il.reshape(Bl * Sl, -1),
                         wl.reshape(Bl * Sl, -1), cfg, plan.model_axis)
        return out.reshape(Bl, Sl, D)

    out = shard_map(body, mesh=plan.mesh,
                    in_specs=(ex_specs, x_spec, x_spec, x_spec),
                    out_specs=x_spec, check_rep=False)(
        params["experts"], x, idx, w)
    if cfg.num_shared_experts:
        out = out + swiglu_apply(params["shared"], x)
    return out, aux


def dispatch_job(job):
    """{shape: {case: {bits: results}}} (see the module's docstring)."""
    base = get_smoke_config(job["arch"])
    params = jax.tree_util.tree_map(jnp.asarray, job["params"])
    out = {}
    for shape in job["shapes"]:
        plan = make_plan(shape)

        def run(params, xs, cots, ste):
            res = {}
            for name, over, _, _ in job["cases"]:
                for bits in job["bits"]:
                    cfg = dataclasses.replace(base, moe_mode="scatter",
                                              moe_a2a_bits=bits, **over)
                    x, cot = xs[name], cots[name]
                    if ste:
                        if not bits:
                            continue
                        fn = lambda p, x: ste_moe_apply(p, x, cfg, plan)
                    elif bits:
                        y, aux = jmoe.moe_apply(params, x, cfg=cfg)
                        res[(name, bits)] = {"y": y,
                                             "lb": aux["moe_lb_loss"]}
                        continue
                    else:
                        fn = lambda p, x: jmoe.moe_apply(p, x, cfg=cfg)

                    def loss(p, x, fn=fn, cot=cot):
                        y, aux = fn(p, x)
                        return jnp.sum(y * cot), (y, aux["moe_lb_loss"])

                    (_, (y, lb)), g = jax.value_and_grad(
                        loss, argnums=(0, 1), has_aux=True)(params, x)
                    res[(name, bits)] = {"y": y, "lb": lb, "grads": g[0],
                                         "x_grad": g[1]}
            return res

        xs = {n: jnp.asarray(x) for n, _, x, _ in job["cases"]}
        cots = {n: jnp.asarray(c) for n, _, _, c in job["cases"]}
        with activation_hints(plan):
            ref = jax.jit(lambda p, x, c: run(p, x, c, False))(params, xs,
                                                               cots)
            ste = jax.jit(lambda p, x, c: run(p, x, c, True))(params, xs,
                                                              cots)
        res = {}
        for (name, bits), r in ref.items():
            e = {"y": np.asarray(r["y"]), "lb": float(r["lb"])}
            if "grads" in r:
                e["grads"] = flat(r["grads"])
                e["x_grad"] = np.asarray(r["x_grad"])
            if (name, bits) in ste:
                s = ste[(name, bits)]
                e["ste_y"] = np.asarray(s["y"])
                e["ste_grads"] = flat(s["grads"])
                e["ste_x_grad"] = np.asarray(s["x_grad"])
            res.setdefault(name, {})[bits] = e
        out[tuple(shape)] = res
    return out


def train_job(job):
    """{shape: {"metrics", "grads", "steps"}} and "world1" (see the
    module's docstring)."""
    cfg = dataclasses.replace(get_smoke_config(job["arch"]), **job["over"])
    params = jax.tree_util.tree_map(jnp.asarray, job["params"])
    hp = TrainHParams(lr=1e-3)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in job["batches"]]
    # the reference's train step (make_train_step without compression):
    # value_and_grad under the mesh's hints, then AdamW, which no hint
    # reaches (compiled once for every mesh)
    update = jax.jit(lambda p, g, o: adamw_update(p, g, o, hp.lr, hp.adamw))
    out = {}
    for shape in job["shapes"]:
        plan = make_plan(shape)
        with activation_hints(plan):
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: jtr.train_loss(p, b, cfg), has_aux=True))
            p, opt = params, adamw_init(params, hp.adamw)
            steps = []
            for i, b in enumerate(batches):
                (_, m), g = fn(p, b)
                if i == 0:
                    out[tuple(shape)] = {
                        "metrics": {k: float(v) for k, v in m.items()},
                        "grads": flat(g)}
                p, opt, om = update(p, g, opt)
                steps.append((float(m["loss"]), float(om["grad_norm"])))
        out[tuple(shape)]["steps"] = steps
    wired = dataclasses.replace(cfg, moe_a2a_bits=8)
    plan = make_plan((1, 1))
    with activation_hints(plan):
        _, m = jax.jit(lambda p, b: jtr.train_loss(p, b, wired))(
            params, batches[0])
    _, m0 = jax.jit(lambda p, b: jtr.train_loss(p, b, wired))(
        params, batches[0])
    out["world1"] = {"wired": {k: float(v) for k, v in m.items()},
                     "plain": {k: float(v) for k, v in m0.items()}}
    return out


def main(src, dst):
    with open(src, "rb") as f:
        jobs = pickle.load(f)
    out = {}
    if "dispatch" in jobs:
        out["dispatch"] = dispatch_job(jobs["dispatch"])
    if "train" in jobs:
        out["train"] = train_job(jobs["train"])
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
