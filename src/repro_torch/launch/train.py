"""The training launcher of the port (the reference's ``launch/train.py``).

Composes the trainer's parts: the synthetic LM pipeline (batches a pure
function of the step), the train step (loss and gradients, optional int8
gradient wire with error feedback, AdamW with optional int8 moments), the
paper's per-layer precision as flags (weights, data, KV), async
checkpoints, and the restart supervisor with its straggler log. Runs on
the CUDA card unless ``--device cpu``.

Trains every arch of the registry from ``lm_batch`` tokens, as the
reference's launcher does: the dense, MoE and MLA decoders (with
multi-token prediction), the recurrent xLSTM and Jamba (a ``--seq-len``
that is not a multiple of the mixers' chunk raises the reference's
ValueError), the encoder hubert (it has an embedding table) and qwen2-vl
(plain RoPE from tokens). Training from a stub frontend's embeddings goes
through ``launch.steps.make_train_step`` with
``configs.shapes.make_batch`` batches; the reference's launcher has no
flag for it.

``--mesh host`` (the default) trains SPMD over ``launch.mesh.
make_host_mesh``: one rank alone (a one-rank group), or N ranks under
``python -m torch.distributed.run --nproc-per-node N`` (gloo on the CPU,
NCCL on cards), the state sharded by the reference's training placements
(``launch.steps.shard_train_state``), each rank fed its rows of the
global batch. Rank 0 prints, checkpoints (each leaf gathered whole: the
checkpoint is the global one) and writes ``--metrics-out``. A MoE arch
trains there too: the host mesh has no model axis, so a ``scatter`` MoE
dispatches the global batch, as the reference's does on that mesh, and
its load-balance loss is the global batch's.
``--mesh single|multi`` train over the reference's 256- and 512-rank
pods (``launch.mesh.make_production_mesh``): the group of
``torch.distributed.run`` must hold exactly that many ranks, else the
mesh raises its ValueError (the pods are laid out on one host only by the
dry run, ``launch.dryrun``).

Usage (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-7b \\
      --smoke --device cpu --steps 20 --batch-size 4 --seq-len 64 --lr 1e-3
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch llama4-maverick-400b-a17b \\
      --smoke --device cpu --steps 4 --batch-size 4 --seq-len 32
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.train --arch yi-34b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time

from .. import resolve_device
from ..checkpoint.ckpt import CheckpointManager, latest_step
from ..configs.registry import get_config, get_smoke_config
from ..core.fixedpoint import FixedPointFormat
from ..core.policy import PrecisionPolicy
from ..data.lm import LMDataConfig, lm_batch
from ..data.pipeline import DataPipeline
from ..optim.adamw import AdamWConfig
from ..optim.compress import CompressionConfig
from ..optim.schedule import cosine_warmup
from ..parallel.sharding import plan_for_mesh
from ..quant.apply import build_model_quant, transformer_layer_names
from ..runtime.fault import StragglerMonitor, TrainSupervisor
from .mesh import (_join_launcher, _launched, close_process_group,
                   make_host_mesh, make_production_mesh)
from .steps import (TrainHParams, init_train_state, load_train_state,
                    make_train_step, shard_train_state, train_state_tree)


def build_quant(cfg, *, weight_bits: int, data_bits: int, kv_bits: int,
                policy_json: str):
    """The reference's flags -> ``ModelQuant``: weights Q2.(bits-2), data
    Q4.(bits-4), KV Q2.(bits-2) (a KV-only policy when only ``kv_bits``);
    a policy file overrides the bit flags."""
    if policy_json:
        with open(policy_json) as f:
            pol = PrecisionPolicy.from_json(f.read())
    elif weight_bits or data_bits:
        names = transformer_layer_names(cfg)
        w = FixedPointFormat(2, weight_bits - 2) if weight_bits else None
        d = FixedPointFormat(4, data_bits - 4) if data_bits else None
        pol = PrecisionPolicy.uniform(names, w, d)
    else:
        pol = None
    if pol is None and not kv_bits:
        return None
    if pol is None:
        names = transformer_layer_names(cfg)
        pol = PrecisionPolicy.uniform(
            names, None, FixedPointFormat(2, kv_bits - 2))
    return build_model_quant(pol, cfg, quantize_kv=kv_bits > 0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--grad-compress", action="store_true",
                    help="int8 gradient wire format + error feedback")
    # per-layer precision (the paper's feature, as first-class flags)
    ap.add_argument("--weight-bits", type=int, default=0)
    ap.add_argument("--data-bits", type=int, default=0)
    ap.add_argument("--kv-bits", type=int, default=0)
    ap.add_argument("--policy", default="", help="PrecisionPolicy json file")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    import torch
    import torch.distributed as dist
    resolve_device(args.device)         # no card: raise, never fall back
    opened = not dist.is_initialized()
    try:
        if args.mesh == "host":
            mesh = make_host_mesh(args.device)
        else:
            if opened and _launched():
                _join_launcher(args.device)
            mesh = make_production_mesh(
                multi_pod=args.mesh == "multi",
                device=torch.device(args.device).type)
        return _train(args, cfg, mesh)
    finally:
        if opened and dist.is_initialized():
            close_process_group()


def _train(args, cfg, mesh):
    import torch.distributed as dist
    plan = plan_for_mesh(mesh)
    lead = dist.get_rank() == 0
    dev = resolve_device(args.device)   # this rank's card (make_host_mesh)

    hp = TrainHParams(
        lr=args.lr,
        adamw=AdamWConfig(quantize_moments=args.int8_moments),
        grad_compress=CompressionConfig() if args.grad_compress else None)
    quant = build_quant(cfg, weight_bits=args.weight_bits,
                        data_bits=args.data_bits, kv_bits=args.kv_bits,
                        policy_json=args.policy)
    dcfg = LMDataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                        batch_size=args.batch_size, seed=args.seed + 1)
    lr_fn = cosine_warmup(args.lr, args.warmup, args.steps)

    train_step = make_train_step(cfg, hp, quant=quant, plan=plan)

    state = init_train_state(cfg, hp, seed=args.seed, device=dev)
    template = train_state_tree(state, cfg, device="meta")
    shard_train_state(state, cfg, plan)
    start_step = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval,
                                 plan=plan)
    if args.resume and args.ckpt_dir and \
            latest_step(args.ckpt_dir) is not None:
        start_step, tree, _ = ckpt.restore_latest(template)
        load_train_state(state, tree, cfg, plan=plan)
        if lead:
            print(f"[train] resumed from step {start_step}")

    pipe = DataPipeline(lambda s: lm_batch(dcfg, s), device=dev,
                        start_step=start_step, plan=plan)
    monitor = StragglerMonitor()

    def one_step(state, step):
        batch = next(pipe)
        return train_step(state, batch, lr=lr_fn(step))

    def save(step, state, force=False):
        # the data state is the step consumed, not the pipeline's own
        # (which counts its prefetched batches: the reference records that,
        # and a supervisor restart then skips them)
        ckpt.maybe_save(step, train_state_tree(state, cfg, plan=plan),
                        extra={"data": {"step": step}}, force=force)

    def save_hook(step, state):
        if ckpt and ckpt.interval > 0 and step % ckpt.interval == 0:
            save(step, state)

    def restore_fn():
        step, tree, extra = ckpt.restore_latest(template)
        load_train_state(state, tree, cfg, plan=plan)
        pipe.restore(extra.get("data", {"step": step}))
        return step, state

    sup = TrainSupervisor(step_fn=one_step, save_hook=save_hook,
                          restore_fn=restore_fn, monitor=monitor)

    log = []
    t_start = time.time()
    step = start_step
    while step < args.steps:
        n = min(args.log_every, args.steps - step)
        state, metrics_list = sup.run(state, step, n)
        step += n
        m = metrics_list[-1]
        loss = float(m["loss"])
        log.append({"step": step, "loss": loss,
                    "grad_norm": float(m["grad_norm"])})
        tok_s = (args.batch_size * args.seq_len * n /
                 max(time.time() - t_start, 1e-9))
        t_start = time.time()
        if lead:
            print(f"[train] step {step:5d} loss {loss:8.4f} grad_norm "
                  f"{float(m['grad_norm']):8.3f} tok/s {tok_s:,.0f}")

    if ckpt:
        save(step, state, force=True)
        ckpt.wait()
    if lead:
        print("[train] straggler summary:", json.dumps(monitor.summary()))
    if lead and args.metrics_out:
        os.makedirs(os.path.dirname(args.metrics_out) or ".", exist_ok=True)
        with open(args.metrics_out, "w") as f:
            json.dump(log, f, indent=1)
    return log


if __name__ == "__main__":
    main()
