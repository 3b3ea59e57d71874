"""Rank functions for ``tests/test_torch_ep.py``, run on spawned gloo ranks
by ``launch.mesh.spawn_ranks``: they import only torch, numpy and the
port (no JAX). One spawn a group size; each function runs every check of
its meshes on one process group and hands back numpy and python values."""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

import _torch_dist_ranks as dist_ranks

CPU = torch.device("cpu")
EXPERTS = ("w_gate", "w_up", "w_down")


def _expert_specs(cfg, plan) -> dict:
    """The reference's training placements of the expert stacks: E over
    "model", F over "data" when it divides."""
    f = "data" if cfg.moe_d_ff % plan.shape["data"] == 0 else None
    return {"w_gate": ("model", None, f), "w_up": ("model", None, f),
            "w_down": ("model", f, None)}


def _rows(plan, B: int) -> tuple:
    """The axes that split a batch of ``B`` rows (``shard_batch``'s)."""
    from repro_torch.parallel.sharding import _axes, _batch_axes_for
    return _axes(_batch_axes_for(plan, B))


def _leaf(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _spy():
    """Record the dtype of every tensor the all-to-all exchange carries:
    as handed to it (the wire's payload: int8 or int16, and the float32
    scales) and as ``all_to_all_single`` sends it (int16 as its bytes)."""
    import torch.distributed as dist

    from repro_torch.parallel import hints
    seen = {"payload": [], "sent": []}
    orig_x, orig_a = hints._exchange, dist.all_to_all_single

    def exchange(t, group):
        seen["payload"].append(str(t.dtype))
        return orig_x(t, group)

    def send(out, inp, *args, **kwargs):
        seen["sent"].append(str(inp.dtype))
        return orig_a(out, inp, *args, **kwargs)

    hints._exchange, dist.all_to_all_single = exchange, send

    def undo():
        hints._exchange, dist.all_to_all_single = orig_x, orig_a
    return seen, undo


def dispatch_cases(plan, base, params, cases, bits_list) -> dict:
    """``moe_apply`` (scatter) of each case under the train step's mark,
    this rank's rows of x in, the expert stacks sharded as the train
    state's and gathered by ``gather_param(keep=("model",))``: per case
    and width this rank's output rows, the load-balance loss, the wire's
    payload dtypes, and the gradients of sum(y * cot) gathered whole
    (the router's and the shared expert's summed over the ranks of other
    rows, x's as this rank's rows)."""
    from repro_torch.models.moe import moe_apply
    from repro_torch.parallel.hints import (all_reduce_over, gather_param,
                                            train_step_mark)
    from repro_torch.parallel.sharding import gather_whole, local_shard
    out = {}
    for name, over, x, cot in cases:
        for bits in bits_list:
            cfg = dataclasses.replace(base, moe_mode="scatter",
                                      moe_a2a_bits=bits, **over)
            axes = _rows(plan, x.shape[0])
            rspec = (axes if len(axes) > 1 else axes[0] if axes else None,
                     None, None)
            xr = local_shard(torch.from_numpy(x), rspec, plan).clone() \
                .requires_grad_(True)
            cr = local_shard(torch.from_numpy(cot), rspec, plan)
            specs = _expert_specs(cfg, plan)
            shards = {k: local_shard(torch.from_numpy(params["experts"][k]),
                                     specs[k], plan).clone()
                      .requires_grad_(True) for k in EXPERTS}
            router = _leaf(params["router"])
            shared = {k: _leaf(v) for k, v in params["shared"].items()}
            seen, undo = _spy()
            try:
                with train_step_mark(plan, axes):
                    ex = {k: gather_param(shards[k], specs[k], axes, plan,
                                          keep=("model",)) for k in EXPERTS}
                    p = types.SimpleNamespace(
                        router=router, shared=types.SimpleNamespace(**shared),
                        **ex)
                    y, aux = moe_apply(p, xr, cfg=cfg)
                torch.sum(y * cr).backward()
            finally:
                undo()
            grads = {f"['experts']['{k}']": gather_whole(
                shards[k].grad, specs[k], plan).numpy() for k in EXPERTS}
            grads["['router']"] = all_reduce_over(router.grad, axes,
                                                  plan).numpy()
            for k, v in shared.items():
                grads[f"['shared']['{k}']"] = all_reduce_over(
                    v.grad, axes, plan).numpy()
            out[(name, bits)] = {
                "y": y.detach().numpy().copy(), "lb": float(aux["moe_lb_loss"].detach()),
                "grads": grads, "x_grad": xr.grad.numpy().copy(),
                "local_experts": tuple(ex["w_gate"].shape),
                "wire": seen, "row_axes": axes}
    return out


def lb_case(plan, base, params, x) -> dict:
    """The load-balance loss of this rank's rows under the mark (the
    global loss on every rank) and its gradient with respect to the
    router, summed over the ranks of other rows."""
    from repro_torch.models.moe import _route
    from repro_torch.parallel.hints import all_reduce_over, train_step_mark
    from repro_torch.parallel.sharding import local_shard
    axes = _rows(plan, x.shape[0])
    rspec = (axes[0] if axes else None, None, None)
    xr = local_shard(torch.from_numpy(x), rspec, plan)
    router = _leaf(params["router"])
    p = types.SimpleNamespace(router=router)
    with train_step_mark(plan, axes):
        _, _, aux = _route(p, xr, base)
    aux["moe_lb_loss"].backward()
    return {"lb": float(aux["moe_lb_loss"].detach()),
            "router_grad": all_reduce_over(router.grad, axes, plan).numpy()}


def training(plan, cfgs, trees, batches, jobs) -> dict:
    """Per arch: step 1's gradients gathered whole (and the metrics),
    three steps' losses and grad norms, each rank's state bytes against
    its spec's; "shared" (an arch name): the int8 wire and AdamW with
    int8 moments on shared gradients, bit for bit the unsharded ones."""
    out = {}
    for arch in jobs.get("grads", ()):
        out[arch] = {"grads": dist_ranks._gathered_grads(
            cfgs[arch], trees[arch], plan, batches[arch][0])}
        steps, state = dist_ranks._steps(cfgs[arch], trees[arch], plan,
                                         batches[arch])
        out[arch]["steps"] = steps
        out[arch]["bytes"] = dist_ranks._state_bytes(state, cfgs[arch], plan)
        first = state["params"].layers[1].mlp
        out[arch]["local_experts"] = tuple(first.w_gate.shape)
        out[arch]["round_trip"] = _round_trip(cfgs[arch], trees[arch],
                                              state, plan)
    if "shared" in jobs:
        out["shared"] = dist_ranks._wire_and_adamw(cfgs[jobs["shared"]], plan)
    return out


def _round_trip(cfg, tree, state, plan) -> dict:
    """The stepped state's tree (each leaf gathered whole, as a
    checkpoint holds it) loaded into a fresh sharded state: whether every
    leaf (masters, moments, step) comes back bit for bit, and the global
    shape of the first expert stack in the tree."""
    from repro_torch.launch.steps import load_train_state, train_state_tree
    tree_out = train_state_tree(state, cfg, plan=plan)
    fresh = dist_ranks._state(cfg, tree, plan, False)
    load_train_state(fresh, tree_out, cfg, plan=plan)

    def leaves(st):
        out = {f"p/{n}": p.detach() for n, p in
               st["params"].named_parameters()}
        out["step"] = st["opt"]["step"]
        for k in ("m", "v"):
            out.update({f"{k}/{n}": t for n, t in st["opt"][k].items()})
        return out

    a, b = leaves(state), leaves(fresh)
    experts = [v for k, v in dist_ranks._flat(tree_out["params"]).items()
               if k.endswith("experts/w_gate")]
    return {"equal": all(torch.equal(a[k], b[k]) for k in a),
            "leaves": len(a), "expert_shape": experts[0].shape}


def serve(cfg, state_path, cases, requests, forced) -> dict:
    """Every case at tp = 2 (``make_serving_mesh(2)``): tokens, step
    logits, host counters and the local expert stacks' shapes."""
    import _torch_tp_ranks as tp_ranks
    from repro_torch.launch.mesh import make_serving_mesh
    model = tp_ranks.load_model(cfg, state_path)
    mesh = make_serving_mesh(2, device="cpu")
    out = {}
    for name, (over, kw) in cases.items():
        ccfg = dataclasses.replace(cfg, **over)
        toks, logits, counters, srv = tp_ranks.serve_case(
            ccfg, model, kw, requests, forced[name], mesh=mesh)
        out[name] = {"tokens": toks, "logits": logits, "counters": counters,
                     "experts": tuple(srv.model.layers[1].mlp.w_gate.shape),
                     "shared_down": tuple(
                         srv.model.layers[1].mlp.shared.w_down.shape)}
    return out


def ep_ranks(rank, meshes, jobs, inputs) -> dict:
    """Every job of every mesh in ``meshes`` (one after another on one
    group): "dispatch", "lb", "train", and "serve" (on the group's
    serving mesh)."""
    out = {}
    for shape in meshes:
        plan = dist_ranks._plan(shape, ("pod", "data", "model")
                                if len(shape) == 3
                                else ("data", "model")[:len(shape)])
        res = {}
        todo = jobs.get(tuple(shape), {})
        if "dispatch" in todo:
            d = inputs["dispatch"]
            res["dispatch"] = dispatch_cases(plan, d["cfg"], d["params"],
                                             d["cases"], d["bits"])
        if "lb" in todo:
            d = inputs["dispatch"]
            res["lb"] = {name: lb_case(plan, d["cfg"], d["params"], x)
                         for name, x in d["lb_inputs"].items()}
        if "train" in todo:
            t = inputs["train"]
            res["train"] = training(plan, t["cfgs"], t["trees"],
                                    t["batches"], todo["train"])
        out[tuple(shape)] = res
    if "serve" in jobs:
        s = inputs["serve"]
        out["serve"] = serve(s["cfg"], s["path"], s["cases"], s["requests"],
                             s["forced"])
    return out


def world_one(rank, cfg, tree, batch) -> dict:
    """On a one-rank group: the mesh step's first step on a (1, 1) plan
    against the plain step, for ``cfg`` as given and at
    ``moe_a2a_bits`` 8: losses, grad norms, and whether every leaf of the
    stepped states is equal."""
    from repro_torch.launch.steps import (init_train_state, make_train_step,
                                          shard_train_state)
    plan = dist_ranks._plan((1, 1))
    out = {}
    for bits in (0, 8):
        c = dataclasses.replace(cfg, moe_a2a_bits=bits)
        hp = dist_ranks._hp(False)
        runs = {}
        for name, p in (("plain", None), ("mesh", plan)):
            state = init_train_state(c, hp, model=dist_ranks._model(c, tree))
            if p is not None:
                shard_train_state(state, c, p)
            _, m = make_train_step(c, hp, plan=p)(state, dist_ranks._t(batch))
            runs[name] = ({k: float(v) for k, v in m.items()},
                          {n: q.detach().clone() for n, q in
                           state["params"].named_parameters()})
        same = all(torch.equal(runs["plain"][1][n], q)
                   for n, q in runs["mesh"][1].items())
        out[bits] = {"plain": runs["plain"][0], "mesh": runs["mesh"][0],
                     "params_equal": same}
    return out
