"""Rank functions for ``tests/test_torch_dist_train.py``, run on spawned
gloo ranks by ``launch.mesh.spawn_ranks``: they import only torch, numpy
and the port (no JAX), so each rank starts fast. Every function runs all
of its checks on one process group, one mesh after another, and hands
back plain numpy and python values."""
from __future__ import annotations

import numpy as np
import torch

CPU = torch.device("cpu")


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _model(cfg, tree):
    from repro_torch.models.transformer import params_from_numpy
    return params_from_numpy(tree, cfg, device=CPU, trainable=True)


def _hp(quantized: bool):
    from repro_torch.launch.steps import TrainHParams
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import CompressionConfig
    return TrainHParams(lr=1e-3, adamw=AdamWConfig(quantize_moments=quantized),
                        grad_compress=CompressionConfig() if quantized
                        else None)


def _quant(cfg, quantized: bool):
    if not quantized:
        return None
    from repro_torch.launch.train import build_quant
    return build_quant(cfg, weight_bits=10, data_bits=12, kv_bits=8,
                       policy_json="")


def _plan(shape, axes=("data", "model")):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import plan_for_mesh
    return plan_for_mesh(make_test_mesh(tuple(shape), tuple(axes)))


def _flat(tree, prefix=""):
    """A nested tree of tensors as {"a/b/0": numpy}."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree.detach().cpu().numpy().copy()}


def _state(cfg, tree, plan, quantized: bool):
    from repro_torch.launch.steps import init_train_state, shard_train_state
    state = init_train_state(cfg, _hp(quantized), model=_model(cfg, tree))
    return shard_train_state(state, cfg, plan)


def _gathered_grads(cfg, tree, plan, batch, quantized=False):
    """Step 1's gradients of the sharded step, each gathered whole."""
    from repro_torch.launch.steps import loss_and_grads, train_state_specs
    from repro_torch.parallel.sharding import gather_whole
    state = _state(cfg, tree, plan, quantized)
    specs = train_state_specs(state, cfg, plan)["params"]
    metrics, grads = loss_and_grads(state["params"], _t(batch), cfg,
                                    quant=_quant(cfg, quantized),
                                    plan=plan, specs=specs)
    whole = {n: gather_whole(g, specs[n], plan).numpy()
             for n, g in grads.items() if g is not None}
    return {k: float(v) for k, v in metrics.items()}, whole


def _steps(cfg, tree, plan, batches, quantized=False):
    """Three sharded steps: per step its loss and grad norm; the state
    after them."""
    from repro_torch.launch.steps import make_train_step
    state = _state(cfg, tree, plan, quantized)
    step = make_train_step(cfg, _hp(quantized), quant=_quant(cfg, quantized),
                           plan=plan)
    out = []
    for b in batches:
        state, m = step(state, _t(b))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, state


def _tensors(tree):
    """A nested tree of numpy arrays as torch tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _lockstep(cfg, tree, plan, batches, starts, quantized=True):
    """Each sharded step from the single-device run's state before it
    (``starts``: global trees, loaded as this rank's shards): per step
    its loss and grad norm; the state after the last."""
    from repro_torch.launch.steps import load_train_state, make_train_step
    state = _state(cfg, tree, plan, quantized)
    step = make_train_step(cfg, _hp(quantized), quant=_quant(cfg, quantized),
                           plan=plan)
    out = []
    for b, start in zip(batches, starts):
        load_train_state(state, _tensors(start), cfg, plan=plan)
        state, m = step(state, _t(b))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, state


def _local_shape(shape, spec, plan) -> tuple:
    """A rank's shard's shape of a ``shape`` tensor under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax is not None:
                out[d] //= plan.shape[ax]
    return tuple(out)


def _state_bytes(state, cfg, plan) -> dict:
    """This rank's state bytes against its spec's local bytes, leaf by
    leaf, and the whole state's."""
    from repro_torch.launch.steps import train_state_specs, _meta_state
    specs = train_state_specs(state, cfg, plan)
    first = next(iter(state["opt"]["m"].values()))
    whole = _meta_state(cfg, int8=isinstance(first, dict),
                        residual="ef_residual" in state)
    have = want = full = 0
    bad = []

    def walk(local, meta, spec, key):
        nonlocal have, want, full
        if isinstance(local, dict):
            for k in local:
                walk(local[k], meta[k], spec[k], f"{key}/{k}")
            return
        size = local.element_size()
        shape = _local_shape(tuple(meta.shape), spec, plan)
        have += local.numel() * size
        want += int(np.prod(shape)) * size
        full += meta.numel() * size
        if tuple(local.shape) != shape:
            bad.append(key)

    walk(dict(state["params"].named_parameters()),
         dict(whole["params"].named_parameters()), specs["params"], "params")
    for k in ("m", "v"):
        walk(state["opt"][k], whole["opt"][k], specs["opt"][k], f"opt/{k}")
    if "ef_residual" in state:
        walk(state["ef_residual"], whole["ef_residual"],
             specs["ef_residual"], "ef_residual")
    return {"have": have, "want": want, "whole": full, "bad": bad}


def _wire_and_adamw(cfg, plan):
    """The int8 wire and AdamW with int8 moments on SHARED gradients (the
    same whole gradients, drawn from one seed, on every rank): sharded
    (each rank its shards, the reductions over the ranks) and whole on
    this rank alone, the sharded results gathered, over two updates.
    Returns, per update, whether the wire's output and residual, the
    moments' grids and per-row scales and the parameters are equal bit
    for bit."""
    from repro_torch.launch.steps import (reference_decay, reference_groups,
                                          shard_train_state,
                                          train_state_specs)
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.compress import (CompressionConfig,
                                            compress_gradients,
                                            error_feedback_init)
    from repro_torch.parallel.hints import ShardReductions
    from repro_torch.parallel.sharding import gather_whole, local_shard
    gen = torch.Generator().manual_seed(7)
    model = Transformer(cfg, device=CPU, trainable=True)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    grads = {n: torch.randn(p.shape, generator=gen) * 1e-2
             for n, p in model.named_parameters()}
    decay = reference_decay(model, cfg)
    groups = reference_groups(model, cfg)
    acfg = AdamWConfig(quantize_moments=True)
    whole = {"params": model, "opt": adamw_init(model, acfg),
             "ef_residual": error_feedback_init(model.named_parameters())}
    whole["ef_residual"] = {n: torch.randn(r.shape, generator=gen) * 1e-3
                            for n, r in whole["ef_residual"].items()}
    local = {"params": Transformer(cfg, device=CPU, trainable=True)}
    with torch.no_grad():
        for (n, p), q in zip(model.named_parameters(),
                             local["params"].parameters()):
            q.copy_(p)
    local["opt"] = adamw_init(local["params"], acfg)
    local["ef_residual"] = {n: r.clone()
                            for n, r in whole["ef_residual"].items()}
    shard_train_state(local, cfg, plan)
    specs = train_state_specs(local, cfg, plan)
    shards = ShardReductions(plan, specs["params"])
    ccfg = CompressionConfig()
    out = {}
    for i in range(2):      # two updates: the second decodes the grids
        wc, wres = compress_gradients(grads, whole["ef_residual"], ccfg,
                                      groups=groups)
        whole["ef_residual"] = wres
        adamw_update(whole["params"], wc, whole["opt"], 1e-3, acfg,
                     decay=decay)
        lg = {n: local_shard(g, specs["params"][n], plan)
              for n, g in grads.items()}
        lc, lres = compress_gradients(lg, local["ef_residual"], ccfg,
                                      groups=groups, shards=shards)
        local["ef_residual"] = lres
        adamw_update(local["params"], lc, local["opt"], 1e-3, acfg,
                     decay=decay, shards=shards)
        wire = all(torch.equal(gather_whole(lc[n], specs["params"][n], plan),
                               wc[n]) for n in wc)
        res = all(torch.equal(gather_whole(lres[n], specs["params"][n],
                                           plan), wres[n]) for n in wres)
        grid = scale = True
        for k in ("m", "v"):
            for n, mv in local["opt"][k].items():
                sp = specs["opt"][k][n]
                grid &= torch.equal(gather_whole(mv["q"], sp["q"], plan),
                                    whole["opt"][k][n]["q"])
                scale &= torch.equal(
                    gather_whole(mv["scale"], sp["scale"], plan),
                    whole["opt"][k][n]["scale"])
        wp = dict(model.named_parameters())
        params = all(torch.equal(gather_whole(p.data, specs["params"][n],
                                              plan), wp[n].data)
                     for n, p in local["params"].named_parameters())
        out[i] = {"wire": wire, "residual": res, "grid": grid,
                  "scale": scale, "params": params}
    return out


def sharded_training(rank, meshes, cfgs, trees, batches, jobs, ckpt_dirs):
    """Every job on every mesh of ``meshes`` (one after another on one
    group): "grads" (step 1's gathered gradients of each batch of
    ``batches["grads"]``), "steps" (three steps' losses and grad norms,
    then the state's bytes against its spec's), "xlstm", "quant" (three
    quantized steps and the wire / AdamW on shared gradients), "save"
    (the stepped state's checkpoint, rank 0 returning the gathered
    tree), "elastic" (``elastic_restore`` of each checkpoint in
    ``ckpt_dirs`` onto the mesh, gathered)."""
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.launch.steps import train_state_tree
    out = {}
    for shape in meshes:
        plan = _plan(shape)
        res = {}
        for job in jobs.get(tuple(shape), ()):
            if job == "grads":
                res["grads"] = {name: _gathered_grads(cfgs["yi"], trees["yi"],
                                                      plan, b)
                                for name, b in batches["grads"].items()}
            elif job == "steps":
                losses, state = _steps(cfgs["yi"], trees["yi"], plan,
                                       batches["steps"])
                res["steps"] = losses
                res["bytes"] = _state_bytes(state, cfgs["yi"], plan)
                if "save" in jobs.get(tuple(shape), ()):
                    tree = train_state_tree(state, cfgs["yi"], plan=plan)
                    save_checkpoint(ckpt_dirs["port"], 3, tree,
                                    extra={"data": {"step": 3}}, plan=plan)
                    res["saved"] = _flat(tree) if rank == 0 else None
            elif job == "xlstm":
                res["xlstm"], _ = _steps(cfgs["xlstm"], trees["xlstm"], plan,
                                         batches["xlstm"])
            elif job == "quant":
                res["quant"], state = _lockstep(cfgs["yi"], trees["yi"],
                                                plan, batches["steps"],
                                                batches["quant_starts"])
                res["quant_bytes"] = _state_bytes(state, cfgs["yi"], plan)
                res["shared"] = _wire_and_adamw(cfgs["yi"], plan)
            elif job == "elastic":
                res["elastic"] = elastic_case(cfgs["yi"], ckpt_dirs, plan)
            elif job == "allreduce":
                res["allreduce"] = allreduce_cases(rank, batches["allreduce"],
                                                   plan, "data")
        out[tuple(shape)] = res
    if "gpipe" in jobs:
        out["gpipe"] = gpipe_cases(batches["gpipe"])
    return out


def elastic_case(cfg, ckpt_dirs, plan) -> dict:
    """``elastic_restore`` of each checkpoint onto ``plan``'s mesh: the
    step and the restored state gathered whole (rank 0's)."""
    from repro_torch.launch.steps import train_state_tree
    from repro_torch.runtime import elastic_restore
    from repro_torch.launch.steps import init_train_state
    out = {}
    for name, d in ckpt_dirs.items():
        tmpl = init_train_state(cfg, _hp(False), seed=5, device=CPU)
        step, state, extra = elastic_restore(d, tmpl, plan.mesh)
        local = {n: tuple(p.shape)
                 for n, p in state["params"].named_parameters()}
        out[name] = {"step": step, "extra": extra, "local": local,
                     "tree": _flat(train_state_tree(state, cfg, plan=plan))}
    return out


def allreduce_cases(rank, cases, plan, axis):
    """``quantized_allreduce`` of this rank's row of each case's input
    over ``axis``; each hop's tensors as the wire saw them (dtypes)."""
    import torch.distributed as dist
    from repro_torch.optim.compress import quantized_allreduce
    from repro_torch.parallel.hints import activation_hints
    seen = []
    orig = dist.batch_isend_irecv

    def spy(ops):
        seen.append(tuple(str(op.tensor.dtype) for op in ops))
        return orig(ops)

    dist.batch_isend_irecv = spy
    out = []
    try:
        with activation_hints(plan):
            for x, bits, mean in cases:
                got = quantized_allreduce(torch.from_numpy(x[rank]), axis,
                                          bits=bits, mean=mean)
                out.append(got.numpy().copy())
    finally:
        dist.batch_isend_irecv = orig
    return {"out": out, "wire": seen}


def allreduce_ring(rank, n, cases):
    """``quantized_allreduce`` on a 1-D mesh of the group's ``n`` ranks."""
    return allreduce_cases(rank, cases, _plan((n,), ("data",)), "data")


def gpipe_cases(cases):
    """``gpipe_apply`` over a 1-D "stage" mesh of the group's ranks: per
    case its output and the gradients of sum(out * cot) with respect to
    this rank's stage weights and the input."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.pipeline import gpipe_apply
    S = dist.get_world_size()
    mesh = make_test_mesh((S,), ("stage",))
    sid = dist.get_rank()
    out = []
    for ws, x, cot in cases:
        W = torch.from_numpy(ws).requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = gpipe_apply(lambda w, h: torch.tanh(h @ w), W, xt, mesh=mesh,
                        axis="stage")
        torch.sum(y * torch.from_numpy(cot)).backward()
        out.append({"out": y.detach().numpy().copy(),
                    "w_grad": W.grad[sid].numpy().copy(),
                    "x_grad": xt.grad.numpy().copy()})
    return out
