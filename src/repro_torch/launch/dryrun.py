"""The pod-scale dry run: lay out every (arch x shape x mesh) cell on one
host and count its step, the reference's ``launch/dryrun.py``.

The reference forces 512 XLA host devices, then lowers and compiles
each cell's train, prefill or decode step under ``jit`` shardings. This
port has no compiler. It opens the dry run's fake process group
(``launch.mesh.fake_group``: 256 or 512 ranks, of which this process is
rank 0), builds the production mesh over it, and runs rank 0's step
eagerly on fake tensors (``FakeTensorMode``: shapes and dtypes, no
data, no memory) under the op-cost recorder (``launch.hlo_cost``). Every
tensor is rank 0's own shard, so every figure is per rank, as the
reference's are per device. Per cell it writes
(``results/torch_dryrun/<tag>/<mesh>_<arch>_<shape>.json``):

  * ``memory``      - the recorder's per-rank bytes: arguments, outputs,
                      temporaries, aliases, peak (the reference's
                      ``memory_analysis`` keys)
  * ``cost``        - FLOPs, bytes and transcendentals of every op
  * ``collectives`` - every c10d op's bytes and ring-model wire bytes
  * ``loop_cost``   - the recorder's ``analyze``: the roofline's terms
  * ``model``       - parameters, active parameters, tokens and the
                      analytic ``model_flops``, the reference's formula

``lower_s`` is the lay-out and counting seconds; nothing compiles, so
``compile_s`` is null. ``benchmarks/roofline.py`` turns the records into
the roofline table.

The cells:
  * train   - ``launch.steps.make_train_step(plan=)`` with AdamW on int8
              moments, on a state from ``shard_train_state`` (a trainable
              ``Transformer`` built on fake tensors) and this rank's rows
              of the batch (``shard_batch``);
  * prefill, decode - the parameters stored under ``param_specs``
              (``inference=`` with ``--tp-decode`` on decode cells), each
              gathered over "data" at use (``gather_param(keep=
              ("model",))``) and the tensor-parallel forward run under
              ``activation_hints``, on this rank's rows and dense caches
              of its KV heads (``parallel.hints.kv_heads``); decode with
              ``make_quant(cfg, kv_bits)``. Two mixers read whole weights
              on every rank, since the port's tensor-parallel forward has
              no sharded form of them: MLA attention and the encoder's
              GELU MLP (their leaves are gathered over "model" too).
              Recurrent states and MLA latents stay whole in their
              caches, as the mixers read them.

No cell reaches a CUDA kernel (the decode cells attend over dense
caches); a fake tensor that reaches one raises
(``kernels.build.refuse_fake``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh single [--tag baseline] [--set loss_chunk=1024] \\
      [--kv-bits 8] [--tp-decode] [--trace-dir D]
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import (FakeTensorMode,
                                           unset_fake_temporarily)

from ..configs.registry import ARCH_IDS, get_config
from ..configs.shapes import SHAPES, applicable, input_specs
from ..core.fixedpoint import FixedPointFormat
from ..core.policy import PrecisionPolicy
from ..models.attention import MLAttention
from ..models.mlp import GeluMLP
from ..models.transformer import Transformer, init_cache
from ..optim.adamw import AdamWConfig
from ..parallel.hints import activation_hints, gather_param, kv_heads
from ..parallel.sharding import (BatchShard, param_specs, plan_for_mesh,
                                 shard_batch)
from ..quant.apply import build_model_quant, transformer_layer_names
from .hlo_analysis import collective_summary, cost_summary, memory_summary
from .hlo_cost import OpCostRecorder, analyze, top_instructions
from .mesh import PRODUCTION_MESHES, fake_group, make_production_mesh
from .steps import (TrainHParams, _shard_leaf, _swapped, init_train_state,
                    make_decode_step, make_embed_decode_step,
                    make_prefill_step, make_train_step, shard_train_state)

# the repository's results/, where benchmarks.roofline reads the records
RESULTS = Path(__file__).resolve().parents[3] / "results" / "torch_dryrun"


def dryrun_config(cfg, shape):
    """Pod-scale numerics: bf16 parameters, chunked cross-entropy for a
    train shape (the reference's)."""
    return dataclasses.replace(
        cfg, param_dtype="bfloat16",
        loss_chunk=2048 if shape.kind == "train" else 0)


def make_quant(cfg, kv_bits: int):
    """A uniform Q(2, kv_bits - 2) KV grid in an int8 (or int16) container,
    weights and activations float; None for ``kv_bits`` <= 0."""
    if kv_bits <= 0:
        return None
    names = transformer_layer_names(cfg)
    pol = PrecisionPolicy.uniform(
        names, None, FixedPointFormat(2, kv_bits - 2))
    return build_model_quant(pol, cfg, quantize_kv=True,
                             quantize_activations=False,
                             kv_container="int8" if kv_bits <= 8 else "int16")


def _whole_leaves(model: Transformer) -> frozenset:
    """Parameters the port's tensor-parallel forward reads whole: MLA
    attention's and the encoder's GELU MLP's."""
    out = set()
    for mname, mod in model.named_modules():
        if isinstance(mod, (MLAttention, GeluMLP)):
            out.update(f"{mname}.{n}" for n, _ in mod.named_parameters())
    return frozenset(out)


def _serving_step(model, plan, specs, step):
    """``step(model, ...)`` with every parameter gathered over "data" at
    use (over "model" too for :func:`_whole_leaves`), its model shard
    marked for the tensor-parallel collectives, under the plan's hints."""
    whole_leaves = _whole_leaves(model)

    def run(*args, **kwargs):
        whole = {}
        for name, p in model.named_parameters():
            spec = specs[name]
            keep = () if name in whole_leaves else (plan.model_axis,)
            t = gather_param(p, spec, (), plan, keep=keep)
            dims = [d for d, ax in enumerate(spec) if ax == plan.model_axis]
            if keep and dims:
                t.tp_dim = dims[0]
            whole[name] = t
        with _swapped(model, whole), activation_hints(plan):
            return step(model, *args, **kwargs)

    return run


def _zeros(specs, device):
    return {k: torch.zeros(shp, dtype=dt, device=device)
            for k, (shp, dt) in specs.items()}


def _own_rows(batch, plan) -> BatchShard:
    """This rank's rows of a global batch, in storage of their own (a
    row block would be a view of the global batch's storage)."""
    rows = shard_batch(batch, plan)
    return BatchShard({k: v.clone() for k, v in rows.items()}, rows.axes)


def build_cell(cfg, shape, mesh, *, kv_bits: int = 0,
               tp_decode: bool = False, model=None, inputs=None, hp=None):
    """This rank's part of one cell (see the module's docstring) as
    ``(run, arguments)``: ``run()`` takes the cell's step once and
    returns its results; ``arguments`` are the step's inputs (a state, a
    model's stored shards, a batch, caches), live before it runs.
    ``model``: a whole model of global shapes (trainable for a train
    cell), sharded here in place; built uninitialized on the mesh's
    device when None (on fake tensors: :func:`lower_cell`). ``inputs``:
    the global batch (train, prefill) or ``{"tokens": (B,)}`` /
    ``{"embeds": (B, 1, D)}`` (decode); zeros when None. ``hp``: a train
    cell's hyperparameters (default: AdamW on int8 moments, the
    reference's dry run). ``mesh``: a ``DeviceMesh`` over the running
    group."""
    plan = plan_for_mesh(mesh)
    dev = torch.device(mesh.device_type)
    with unset_fake_temporarily():      # a host-side config, not data
        quant = make_quant(cfg, kv_bits) if shape.kind == "decode" else None
    specs_in = input_specs(cfg, shape, quant=quant)
    if shape.kind == "train":
        hp = hp or TrainHParams(adamw=AdamWConfig(quantize_moments=True))
        if model is None:
            model = Transformer(cfg, device=dev, trainable=True)
        state = shard_train_state(init_train_state(cfg, hp, model=model),
                                  cfg, plan)
        rows = _own_rows(inputs if inputs is not None
                         else _zeros(specs_in, dev), plan)
        step = make_train_step(cfg, hp, plan=plan)
        return (lambda: step(state, rows)), (state, dict(rows))

    if model is None:
        model = Transformer(cfg, device=dev)
    specs = param_specs(model, cfg, plan, inference=(
        tp_decode and shape.kind == "decode"))
    for name, p in model.named_parameters():
        p.data = _shard_leaf(p.data, specs[name], plan)
    if shape.kind == "prefill":
        rows = _own_rows(inputs if inputs is not None
                         else _zeros(specs_in, dev), plan)
        step = _serving_step(model, plan, specs,
                             make_prefill_step(cfg, max_len=shape.seq_len))
        kw = {k: v for k, v in rows.items() if k not in ("tokens", "labels")}
        return (lambda: step(rows.get("tokens"), **kw)), (model, dict(rows))

    key = "embeds" if "embeds" in specs_in else "tokens"
    if inputs is None:
        inputs = _zeros({key: specs_in[key]}, dev)
    first = _own_rows(inputs, plan)[key]
    caches = init_cache(cfg, quant, None, dev, batch=first.shape[0],
                        max_len=shape.seq_len, kv_heads=kv_heads(cfg, plan))
    # the position as the host holds it (a 0-d tensor would be read back:
    # a data-dependent value): the last slot of a full cache
    pos = shape.seq_len - 1
    if key == "embeds":
        step = make_embed_decode_step(cfg, quant=quant)
        args = (first, pos, caches)
    else:
        step = make_decode_step(cfg, quant=quant)
        args = (first, pos, caches, None)
    step = _serving_step(model, plan, specs, step)
    return (lambda: step(*args)), (model, first, caches)


def lower_cell(cfg, shape, mesh, *, kv_bits: int = 0,
               tp_decode: bool = False, hp=None) -> OpCostRecorder:
    """Lay out this rank's part of one cell on fake tensors
    (:func:`build_cell`) and run its step once under the op-cost
    recorder; returns the recorder. ``mesh`` is a ``DeviceMesh`` over a
    running group (the dry run's fake one)."""
    rec = OpCostRecorder(cfg)
    with FakeTensorMode():
        run, arguments = build_cell(cfg, shape, mesh, kv_bits=kv_bits,
                                    tp_decode=tp_decode, hp=hp)
        rec.track(*arguments)
        with rec:
            out = run()
        rec.outputs(out)
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             kv_bits: int = 0, overrides=None, trace_dir=None,
             tp_decode: bool = False, mesh=None):
    """One cell's record (see the module's docstring). ``mesh``: the
    production mesh of ``mesh_kind`` over the running group when None
    (the group must hold its 256 or 512 ranks)."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if not applicable(cfg, shape):
        return {"skipped": True, "reason": "not applicable"}
    cfg = dryrun_config(cfg, shape)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "kv_bits": kv_bits, "overrides": overrides or {},
           "tp_decode": tp_decode, "skipped": False}
    t0 = time.time()
    counted = lower_cell(cfg, shape, mesh, kv_bits=kv_bits,
                         tp_decode=tp_decode)
    rec["lower_s"] = round(time.time() - t0, 2)
    rec["compile_s"] = None

    rec["memory"] = memory_summary(counted)
    rec["cost"] = cost_summary(counted)
    rec["collectives"] = collective_summary(counted.collectives)
    rec["loop_cost"] = analyze(counted)
    rec["hlo_bytes"] = None
    rec["ops"] = sum(r["count"] for r in counted.by_op.values())
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        with open(os.path.join(
                trace_dir, f"{mesh_kind}_{arch}_{shape_name}.ops.txt"),
                "w") as f:
            for r in top_instructions(counted, n=len(counted.by_op)):
                f.write(f"{r['op']}\tcount={r['count']}\t"
                        f"flops={r['flops']:.6g}\tbytes={r['bytes']:.6g}\t"
                        f"wire={r['wire_bytes']:.6g}\n")

    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind in ("train", "prefill") else shape.global_batch)
    factor = 6 if shape.kind == "train" else 2
    rec["model"] = {
        "n_params": n_params, "n_active_params": n_active,
        "tokens_per_step": tokens,
        "model_flops": float(factor * n_active * tokens),
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "kind": shape.kind,
    }
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--kv-bits", type=int, default=0)
    ap.add_argument("--tp-decode", action="store_true",
                    help="inference TP sharding for decode cells (no FSDP "
                         "weight gathers per token)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=PYVALUE", dest="sets")
    ap.add_argument("--out", default=str(RESULTS))
    ap.add_argument("--trace-dir", default=None,
                    help="also write each cell's ops, dearest first")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = (["single", "multi"] if args.mesh == "both" else [args.mesh])
    overrides = {}
    for s in args.sets:
        k, v = s.split("=", 1)
        overrides[k] = ast.literal_eval(v)

    outdir = os.path.join(args.out, args.tag)
    os.makedirs(outdir, exist_ok=True)
    failures = []
    for mesh_kind in meshes:
        with fake_group(math.prod(PRODUCTION_MESHES[mesh_kind == "multi"][0])):
            for arch in archs:
                for shp in shapes:
                    path = os.path.join(outdir,
                                        f"{mesh_kind}_{arch}_{shp}.json")
                    if os.path.exists(path) and not args.force:
                        print(f"[skip cached] {mesh_kind:6s} {arch} {shp}")
                        continue
                    try:
                        rec = run_cell(arch, shp, mesh_kind,
                                       kv_bits=args.kv_bits,
                                       overrides=overrides,
                                       trace_dir=args.trace_dir,
                                       tp_decode=args.tp_decode)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        traceback.print_exc()
                        failures.append((arch, shp, mesh_kind, repr(e)))
                        continue
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    if rec.get("skipped"):
                        print(f"[n/a ] {mesh_kind:6s} {arch:26s} {shp}")
                        continue
                    mem = rec["memory"]["peak_memory_in_bytes"] / 2**30
                    lc = rec["loop_cost"]
                    print(f"[ok  ] {mesh_kind:6s} {arch:26s} {shp:12s} "
                          f"peak={mem:7.2f}GiB flops={lc['flops']:.3e} "
                          f"hbm={lc['hbm_bytes']:.3e} "
                          f"wire={lc['wire_bytes'] / 2**20:9.1f}MiB "
                          f"lay_out={rec['lower_s']:.0f}s", flush=True)
    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nall requested cells laid out OK")


if __name__ == "__main__":
    main()
