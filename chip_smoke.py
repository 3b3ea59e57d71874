#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --phase kernels
    python3 chip_smoke.py --phase cnn    # phase 4 alone, no kernel build
    python3 chip_smoke.py --phase tier   # the build and [tier] alone
    python3 chip_smoke.py --phase moe    # the build and [moe] alone
    python3 chip_smoke.py --phase ssm    # the build and [ssm] alone
    python3 chip_smoke.py --phase frontend   # the build and [frontend]
    python3 chip_smoke.py --phase bench  # the build and [bench] alone
    python3 chip_smoke.py --phase replicas   # the build and [replicas]
    python3 chip_smoke.py --phase train  # the build and [train] alone
    python3 chip_smoke.py --phase train2 # the build and [train2] alone
    python3 chip_smoke.py --phase dist   # [dist] alone, no kernel build
    python3 chip_smoke.py --phase ep     # [ep] alone, no kernel build
    python3 chip_smoke.py --phase dryrun # [dryrun] alone, no kernel build

Phases, each of which raises on failure (no phase is caught):

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and print the build time;
2. kernels vs their plain PyTorch versions at the served shapes
   (qwen2-72b attention: 64 query heads, 8 KV heads, head_dim 128, page
   size 16): decode (S = 1, 8 rows, 1-2k keys) and a 32-query prefill
   chunk, for float (bf16), int8 and int4 pages, and at the served
   contexts (8 rows of 64-544 keys, int8 and int4); max abs error, kernel /
   plain / bound / library times, the split plan; then the kernel entry point
   (``kernels.ops``) at qwen2-72b's widths: the KV-head-blocked attention
   (``block_kv=True``) on the same six cases, ``qmatmul`` of 8 and 256
   rows (bf16 and float32) by the layer-0 up-projection's int8 grid from
   ``quantize_param_tree`` and of 8 rows by a down-projection-shaped
   (29568, 8192) int8 grid, each on the tensor-core route (its tile,
   splits, blocks per SM and shared memory printed), ``quant_cast`` of a
   prefill residual and that weight at four formats, and
   ``pack``/``unpack`` of its grid at 2-16 bits, each against its plain
   version; and the port's kernel bench;
3. the served main path: ``BatchedServer`` with qwen2-72b at full width
   cut to 8 layers (bf16, random weights from a seeded generator), paged
   int8 and int4 KV, bucketed prefill, 24 requests of 64-512 prompt tokens
   and 32 new tokens at batch 8, through the kernel and through the gather
   route; every request finishes, the kernel ran once per layer per
   forward, and the two routes' tokens agree; the same requests with
   ``fused="on"`` (one ragged program per cycle, B1 once per layer per
   program, programs == cycles, the fused kernel route fed the gather
   route's tokens passes the gate; decode-step ms, tok/s and cycles beside
   the separate run's); ``[prefix]``: 24 requests over 4 shared 200-token
   system prompts with the prefix cache off and on, per-page scales (int8,
   int4) and a per-layer profile (bf16, int4 and int8 layers) through both
   routes, the tracer on (its Chrome trace written to
   ``chiprun_out/prefix_trace.json``, the SLO summary and host ms per span
   printed) and a 120-page pool that evicts: teacher-forced gates, B1 held
   against its plain version on the pools of one captured served decode
   step, the prefix counters equal to the smoke config's on the CPU for
   the same trace; ``[tier]``: 59 requests of a bursty two-tenant trace
   from ``core.traffic.generate_trace`` (a deadlined chat tenant over 4
   shared 200-token prompts, a no-deadline batch tenant) on a 160-page
   pool with SLO scheduling, preemption and the host tier, sync and async
   pager, at int8 and int4, with the quant tier on a bf16 pool, with the
   predictor, and from a restored prefix snapshot, each against an
   uninterrupted roomy FIFO run of its container: teacher-forced gates,
   host counters equal to the CPU rehearsal's, async equal to sync,
   async demote / promote byte for byte over rewritten pages, B1 against
   its plain version on pools captured after promotions and quant-tier
   restores, pager latencies and at-rest bytes per tier (the async run's
   Chrome trace, pager track included, to ``chiprun_out/tier_trace.json``);
   a ``torch.profiler`` window over decode steps of
   the int8 kernel-route run: B1's share of device time and the device's
   idle share; dense int8 slabs (``page_size=0``, stepwise prefill) on 8
   requests of 16-48 prompt tokens and 16 new tokens against the paged
   gather route (the gate, KV bytes and peak memory of each); and one
   forward under weights Q2.6 / data Q4.12 (logits finite, weights on the
   grid, equal to a data-only forward on pre-quantized weights) with
   ``policy_footprint_report`` for the full 80-layer config; then, the
   qwen2-72b model freed, ``[moe]``: llama4-maverick-400b-a17b at its
   published widths cut to 2 layers (a dense layer and a MoE layer of 128
   experts top-1 plus a shared expert; attention G = 40 / 8 = 5) served
   on paged pools through B1 (16 requests of 32-160 prompt tokens and 16
   new, batch 8): eval_all at int8 on both routes and int4, the
   published scatter dispatch (stepwise by the server's rule) on both
   routes, and the kernel-route scatter run again through
   ``BatchedServer(mesh=make_serving_mesh(1))`` on a one-rank NCCL group
   (experts split E / 1, no copy: bit for bit the plain run); then
   deepseek-v3-671b cut to 4 layers (3 dense, 1 MoE of 256
   experts top-8, sigmoid router; MLA) on dense latent caches (8
   requests of 32-96 prompt tokens and 16 new, stepwise): bf16 and int8
   latents on the expanded route, int8 on the absorbed route:
   teacher-forced gates, B1 against its plain version on the pools of
   one captured decode step at G = 5 (int8, int4), B1 once per layer per
   program, host counters equal to the smoke configs' on the CPU (a
   child process) for the same traces, tok/s, decode-step ms and peak
   memory of each run, the phase time against its 60 s budget; then,
   those models freed, ``[ssm]``: xlstm-350m cut to 8 of its 24 layers
   (7 mLSTM blocks and 1 sLSTM block, d_model 1024) on dense recurrent
   states, bf16 and with its mLSTM memories on the Q2.6 grid (kv_bits
   8), and jamba-v0.1-52b at its published widths cut to one 8-layer
   period (7 Mamba layers, one attention layer at G = 32 / 8 = 4, MoE of
   16 experts top-2 scatter on the odd layers) on paged int8 pools
   through both routes and int4 through B1, 8 requests of 16-48 prompt
   tokens and 16 new at batch 4, stepwise prefill: teacher-forced gates,
   B1 against its plain version on the pools of one captured decode
   step at G = 4, three requests
   served alone against the same three batched (a slot's recurrent
   states restart on admission and stay put in the other slots), host
   counters against the smoke configs on the CPU, and (f) jamba at exact
   routing with SLO scheduling, the host tier and preemption at batch
   size 1 (three requests, two preemptions: a preempted request resumes
   on its parked recurrent state rows) teacher-forced by the same
   requests served uninterrupted, its counters against the CPU's; and
   the first 2 requests of (d) and of xlstm's (a) (on pages: the mesh
   needs them) served plain and through ``BatchedServer(mesh=
   make_serving_mesh(1))`` on a one-rank NCCL group (the mixers whole,
   their gathers and reductions on the group): tokens and every host
   counter bit for bit, every parameter a view, B1 against its plain
   version on a captured decode step of jamba's mesh run; the
   phase time against its 60 s budget; then, those models freed,
   ``[frontend]``: hubert-xlarge at its published widths and depth (48
   layers, bidirectional, GELU FFN) on stub frame embeddings at 4 x 1024
   (``attend_full``) and 2 x 2048 frames (the non-causal chunked
   attention): ms a forward, frames/s against the bound, a
   non-causality probe and a forward at weights Q2.6 / data Q4.12; then
   qwen2-vl-2b at its published widths and depth (28 layers, B1 at G =
   12 / 2 = 6) served from tokens (8 requests of 16-48 prompt tokens and
   16 new, batch 4, bucketed prefill): int8 gather, int8 kernel
   teacher-forced by it (gated), int4 kernel; B1 against its plain
   version on a captured decode step and a bucketed S = 32 prefill
   forward of each kernel run, counters against qwen2-vl-2b-smoke's on
   the CPU, the first 2 requests of the kernel run on a one-rank NCCL
   mesh as ``[ssm]``'s; and its embeds path: ``prefill`` of stub patch embeddings
   with M-RoPE ids (a 16 x 16 grid, then 32 text positions) and 8
   embed-decode steps, each against a forward over the extended sequence
   within the reference's decode-consistency bound; the phase time
   against its 45 s budget; then, those models freed, ``[bench]``: the
   port's serving benches (``benchmarks.paged_serve``'s five workloads
   and ``benchmarks.traffic.run_serve``) with qwen2-72b at its published
   widths cut to 6 layers, on the smoke config's request traces (their
   token ids are ids of the full vocabulary too): the mixed workload's
   five rows (dense, paged int8 stepwise, int8, int4 and int8 through B1)
   and batched prefill, prefix, overcommit, adapt, ragged and the traffic
   harness's predictor A/B, every token gate teacher-forced (the
   free-running agreement printed beside it), every other gate as the
   reference's, B1 against its plain version on the kernel row's own
   inputs (one served decode step and one bucketed prefill forward,
   every layer), and every workload's host counters equal to the same
   benches' on the smoke config on the CPU (a child process; the
   predictor-on arm, which reads the wall clock, left out); the phase
   time against its 60 s budget; then, that model freed,
   ``[replicas]``: qwen2-72b at its published widths cut to 4 layers on
   the reference's overload trace (``--fast``, 29 requests), every
   server through B1 on int8 pages with the prefix cache, the host tier,
   SLO scheduling and the async pager: (a) the 1-replica
   ``ReplicaFrontend`` against the plain server, bit for bit in tokens,
   done flags and finish steps; (b) 1 against 2 replicas sharing the
   card and the weights (``benchmarks.traffic.run_replicas``,
   teacher-forced): routed requests per replica, affinity hits,
   rebalances, shared prefix pages, goodput (2 replicas strictly above
   1), tok/s, peak memory and B1 launches per arm, and each arm's
   frontend and namespaced replica counters equal to the same bench's
   on the smoke config at the card's KV geometry on the CPU (a child
   process); (c) ``BatchedServer(mesh=make_serving_mesh(1))`` on a
   one-rank NCCL group against the plain server, page scales, the host
   tier and the quant tier on (a 10-page pool: it requantizes): the
   same tokens bit for bit and the same counters, the quant tier's
   included, and the same peak tier bytes, B1 against its plain
   version on one captured decode step, every layer; the phase time
   against its 45 s budget; then, that model freed, ``[train]``:
   (a) deepseek-7b-smoke trained 5 steps on the card against the same
   steps on the CPU (a child process; loss and grad norm within rtol
   1e-5) and AdamW with int8 moments fed the same gradients on both
   (parameters within 1e-6, moment grids equal but for counted one-step
   flips); (b) deepseek-7b at its published widths (d_model 4096, 32
   heads over 32 KV heads, d_ff 11008, vocab 102400, bf16 compute over
   float32 masters) cut to 8 of 30 layers, trained 20 steps of 4 x 512
   tokens from the port's ``lm_batch`` at lr 3e-4 with a 5-step cosine
   warm-up, in two arms: fp32 moments (a ``torch.profiler`` window over
   two steps) and weights Q2.8 / data Q4.8 / KV Q4.4 with int8 moments
   and the int8 gradient wire: losses at steps 1, 10 and 20 (finite, the
   last five below step 1's), step ms by CUDA events, tok/s, AdamW's
   share of a step, peak memory (under 80 GB) and optimizer-state bytes;
   in the quantized arm every block matrix's step-1 gradient nonzero
   (C5); (c) ``TrainSupervisor`` with a checkpoint every 3 steps and a
   ``FaultInjection`` at step 4 against an uninterrupted run (final loss
   within rtol 1e-4; parameters' max difference and bitwise equality
   printed), a bf16 checkpoint of the card state bit for bit (C6); (d)
   the fp32 arm's weights through ``params_to_numpy`` and
   ``params_from_numpy`` into a bf16 serving model, served by
   ``BatchedServer`` (int8 pages of 16, batch 4, 8 requests of 64-256
   prompt tokens from ``lm_batch``, 16 new) on the gather route, the
   kernel route fed its tokens (gated) and the kernel route free: B1 at
   G = 32 / 32 = 1 held against its plain version on one captured decode
   step and one 32-query prefill forward, every layer; the phase time
   against its 60 s budget; then, that model freed, ``[train2]``: (a)
   xlstm-350m-smoke, jamba-smoke at eval_all and at the published
   scatter dispatch, hubert-xlarge-smoke from frame embeddings and
   qwen2-vl-2b-smoke from patch embeddings with M-RoPE ids (and
   xlstm-350m-smoke again with int8 moments and the int8 wire) trained 5
   steps on the card, each step then taken on the CPU from the card's
   starting state (a child process): loss within rtol 1e-5, grad norm
   within rtol 1e-5 for the encoder and the VLM, the recurrent archs'
   gradients by blocks in lockstep within 1e-4 of each leaf's largest
   magnitude, the wire's output equal but for counted one-step flips;
   the free-running CPU steps printed beside them; (b) xlstm-350m at its
   published widths and depth (24 layers: 21 mLSTM, 3 sLSTM; d_model
   1024, vocab 50304, tied, bf16 over float32 masters), 4 and 3 steps of
   4 x 512 ``lm_batch`` tokens (a state crosses one chunk boundary of
   256; a step is ~3 s, host-bound) at lr 1e-3 with a 2-step warm-up, in
   two arms: fp32 moments (a ``torch.profiler`` window over step 4) and
   W10 / D12 / KV8 (the
   mLSTM memories on Q4.4, the KV format that D12 gives under KV8,
   straight-through) with int8 moments and the int8 wire: losses, step
   ms by CUDA events, tok/s, AdamW's share, peak memory; in arm 2 every
   block matrix's step-1 gradient nonzero (C5) and the gradient reaching
   every chunk boundary's state nonzero (C8); (c) hubert-xlarge at its
   published widths and depth (48 bidirectional layers, tanh-GELU FFN)
   trained from stub frame embeddings at 4 x 512 with unit labels over
   504 (profiled), as (b)'s arm 1; (d) qwen2-vl-2b at its published
   widths and depth trained from patch embeddings with M-RoPE ids
   (``make_batch`` at 512), then served as ``[train]`` (d) on 8 requests
   of 40-96 prompt tokens and 12 new: B1 at G = 12 / 2 = 6 held against
   its plain version; the phase time against its 60 s budget; then
   ``[dist]``, the sharded trainer on a one-rank NCCL group
   (``make_host_mesh("cuda")``): (a) deepseek-7b at published widths cut
   to 2 layers, 5 steps of 4 x 512 ``lm_batch`` tokens through
   ``make_train_step(plan=)`` against 5 plain steps from the same state,
   fp32 moments: losses, grad norms and every state leaf bit for bit;
   (b) the same with W10 / D12 / KV8, int8 moments and the int8 wire;
   (c) a deepseek-7b-smoke checkpoint written under the plan and
   ``elastic_restore``d onto a plain state, bit for bit; (d) the trainer
   under ``python -m torch.distributed.run --nproc-per-node 1`` (a child
   process) against the plain CLI, losses within rtol 1e-5; (e)
   ``quantized_allreduce`` and ``gpipe_apply`` (S = 1) on CUDA tensors;
   step ms (mesh and plain), peak memory, the phase time against its
   45 s budget; then ``[ep]``, expert parallelism on a one-rank NCCL
   group with a ("data", "model") mesh: (a) one MoE layer of
   deepseek-v3 at published widths (256 experts of F 2048 top-8, D 7168,
   a shared expert, sigmoid router), scatter, bf16, 4 x 512 tokens:
   ``moe_apply`` forward and backward under the train step's mark
   against the plain dispatch (at 8 and 16 bits with the wire's
   quantize-dequantize at its two points), the output and every
   gradient bit for bit, ms and peak memory of each, and the wire's
   exchange on the NCCL model group itself (int8 / int16 payload and
   float32 scales); (b) jamba-v0.1 at published widths cut to 2 layers
   (Mamba + MLP, Mamba + 16 experts top-2), scatter, int8 moments, 3
   steps of 4 x 512 tokens: the plain step, the expert-parallel mesh
   step (bit for bit: losses, grad norms, a checksum of every state
   leaf) and the mesh step on the 8-bit wire (finite losses, every
   expert reached by step 1's gradient); step ms, peak memory, the
   phase time against its 45 s budget; then ``[dryrun]``, the dry run's
   prediction against a real run at world size 1: (a) ``[train]``'s
   arm 1 (deepseek-7b x 8 layers, 4 x 512 tokens, fp32 moments) laid out
   on fake tensors at a one-rank mesh over the fake group
   (``launch.dryrun``, counted by the op-cost recorder), then 3 real
   steps; (b) qwen2-72b x 8 layers, one decode step at batch 8 on dense
   int8 slabs of 4096 tokens, laid out, then 16 real steps timed: for
   each, counted FLOPs fake against real (``FlopCounterMode``; equal),
   the predicted peak against ``max_memory_allocated`` (within 10%), and
   the roofline bound at the card's data-sheet peaks against the
   CUDA-event step time (the roofline fraction on the card); the phase
   time against its 45 s budget;
4. ``[cnn]``, the paper's own experiment (no kernel: torch ops, as the
   reference runs jnp there): LeNet, Convnet and AlexNet-small at the
   paper's widths trained with the reference's recipe from a seeded
   generator (LeNet's top-1 at least 0.85); the card held against the
   port on the CPU (logits of 64 images within 1e-4, top-1 counts of 1024
   under 8 policies within one sample, one policy twice identical); the
   Fig. 2 and Fig. 3 sweeps, the Fig. 4 accounting, and the greedy and
   sensitivity searches of Fig. 5 / Table 2 on the 1024-image eval set
   (each net has a point within 10%, each selected point re-evaluates
   within its tolerance, LeNet's TR at 1% below 1); LeNet's greedy
   trajectory replayed on the CPU (each point within one sample, the same
   1% point); evaluations, ms an evaluation, TR and bits per layer, peak
   memory.

Phase 1 also prints ptxas's registers, shared memory and spills for the
tensor-core kernels (attention and B3) and the count of HMMA
(tensor-core) instructions in each library; it fails if B3's library has
none or its tensor-core kernel spills. Kernel times are CUDA events
around one launch, L2 flushed before it and a device-side sleep enqueued
ahead of it, so the events bracket device work and not the host's
enqueue; the attention cases also print the wrapper's host time a call.

The line before the last is the kernels' JSON record; the last line is the
run's verdict, ``{"ok": true, "device": {...}}``. Exits non-zero, with no
verdict, when there is no CUDA card or the port is not beside this file.
Float32 matmuls and convolutions run without TF32 here.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H, KV, HD, PS = 64, 8, 128, 16     # qwen2-72b attention at page size 16
TOL = 1e-4                          # abs + rel, float32 outputs
HBM_BYTES_PER_S = 3.35e12           # H100 SXM (data sheet)
BF16_FLOP_PER_S = 989e12            # dense bf16 tensor cores (data sheet)
FP32_FLOP_PER_S = 67e12            # float32 outside the tensor cores
REPLACES = "src/repro/kernels/paged_kv_attention.py:66"
SOURCE = "src/repro_torch/kernels/csrc/paged_kv_attention.cu"
D_MODEL, D_FF = 8192, 29568         # qwen2-72b's MLP up-projection
NUM_LAYERS = 8                      # qwen2-72b's 80 cut to fit one card
SEED = 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# the port's token-agreement helpers (``benchmarks/lm_precision.py``),
# bound by main() once the port is on the path; ``accuracy_gate`` is bound
# with GATE: every gate here allows 15% of requests under the 0.5 floor (a
# random-init model's argmax ties can flip one request entirely)
accuracy_gate = decode_agreement = DecodeTap = FusedTap = None
GATE = dict(min_agreement=0.9, request_floor=0.5, allowed_below_floor=0.15)

SLEEP_CYCLES = 400_000              # ~0.2 ms of device time at 1.98 GHz


def cuda_ms(fn, *, reps: int, flush=None) -> float:
    """Mean device ms of ``fn`` over ``reps`` launches after a warm-up,
    each timed by its own CUDA event pair; ``flush`` runs (untimed) before
    each launch to evict the inputs from L2, then a device-side sleep keeps
    the card busy while the host enqueues ``fn``, so the events time the
    device's work and not the host's."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version
# ---------------------------------------------------------------------------
def attention_inputs(rng, *, bits: int, S: int, B: int = 8,
                     keys=(1024, 2048)):
    """Served-width attention inputs on the card: a fragmented pool at
    ``keys`` (lo, hi) keys per row, bf16 queries, the chunk's S queries
    ending at each row's last key. Returns (args, kv_len as numpy)."""
    import torch
    from repro_torch.kernels.ref import make_fragmented_pool

    dev = torch.device("cuda")
    kv_len = rng.integers(keys[0], keys[1] + 1, B).astype(np.int32)
    NP = -(-int(kv_len.max()) // PS)
    kq, vq, ks, vs, pt = make_fragmented_pool(rng, B, NP, PS, KV, HD, bits)
    kp, vp = torch.from_numpy(kq).to(dev), torch.from_numpy(vq).to(dev)
    if bits == 0:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    ksc, vsc = torch.from_numpy(ks).to(dev), torch.from_numpy(vs).to(dev)
    ptd = torch.from_numpy(pt).to(dev)
    q = torch.from_numpy(rng.normal(size=(B, S, H, HD)).astype(
        np.float32)).to(dev, torch.bfloat16)
    lens = torch.from_numpy(kv_len).to(dev)
    qs = lens - S
    return (q, kp, vp, ksc, vsc, ptd, qs, lens), kv_len


def host_ms(fn, *, reps: int = 50) -> float:
    """Host ms a call of ``fn`` takes to return (its enqueue, no sync in
    the loop), after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return ms


def sdpa_yardstick(args, *, bits: int, plain, flush):
    """Yardstick only: SDPA on the gathered, dequantized K/V (the port
    never calls it); the gather itself is outside the timed call. Returns
    (max abs difference from ``plain``, ms)."""
    import torch
    from repro_torch.core.paged_kv import paged_gather

    q, kp, vp, ksc, vsc, ptd, qs, lens = args
    dev, S = q.device, q.shape[1]
    container = {0: "fp", 8: "int8", 4: "int4"}[bits]
    pool = {"k_pages": kp, "v_pages": vp, "k_scale": ksc, "v_scale": vsc}
    kd, vd = paged_gather(pool, ptd, container=container, head_dim=HD,
                          dtype=torch.bfloat16)
    T = kd.shape[1]
    kh = kd.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
    vh = vd.transpose(1, 2).repeat_interleave(H // KV, dim=1).contiguous()
    qh = q.transpose(1, 2).contiguous()
    pos = torch.arange(T, device=dev)
    qpos = qs[:, None] + torch.arange(S, device=dev)[None, :]
    mask = ((pos[None, None, :] <= qpos[:, :, None])
            & (pos[None, None, :] < lens[:, None, None]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out = sdpa(qh, kh, vh, attn_mask=mask).transpose(1, 2).float()
    lib_err = float((lib_out - plain).abs().max())
    return lib_err, cuda_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask),
                            reps=20, flush=flush)


def attention_bound(args, kv_len, out):
    """Least time for this run's data: every visible page read once (K and
    V, plus its two scales and table entry), q read and out written once;
    QK^T and PV over the visible keys at the bf16 tensor-core rate.
    Returns (bound_ms, bound_by, bytes, flops)."""
    q, kp = args[0], args[1]
    B, S = q.shape[0], q.shape[1]
    pages = int(np.sum(-(-kv_len // PS)))
    page_bytes = PS * KV * kp.shape[-1] * kp.element_size()
    nbytes = (pages * (2 * page_bytes + 2 * 4 + 4) + q.numel() * 2
              + out.numel() * 4 + 2 * B * 4)
    visible = sum(int(kv_len[b]) - S + i + 1 for b in range(B)
                  for i in range(S))
    flops = 4.0 * visible * H * HD
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, flops)


def flush_fn():
    """Untimed L2 eviction before a timed launch (96 MB > the 50 MB L2)."""
    import torch
    return torch.empty(96 * 2 ** 20, dtype=torch.uint8,
                       device="cuda").zero_


def kernel_case(rng, *, bits: int, S: int, B: int = 8,
                block_kv: bool = False, keys=(1024, 2048)):
    """One kernel-vs-plain comparison at the served attention shapes,
    through ``kernels.ops``. With ``block_kv`` it is B2's: its launch is
    counted in the case and it is also held against B1 (1e-5)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_kv_attention as pka

    chunk = pka.paged_kv_attention_chunk
    args, kv_len = attention_inputs(rng, bits=bits, S=S, B=B, keys=keys)
    chunk.kvblock_launches = 0                  # the entry point's launch
    out = ops.paged_kv_attention_chunk(*args, bits=bits, block_kv=block_kv)
    launches = chunk.kvblock_launches
    plan = dict(chunk.last_plan)
    torch.cuda.synchronize()
    plain = pka.paged_kv_attention_chunk_plain(*args, bits=bits)
    err = float((out - plain).abs().max())
    ok = bool(torch.isfinite(out).all()) and torch.allclose(
        out, plain, rtol=TOL, atol=TOL)
    extra, vs_b1 = {}, ""
    if block_kv:
        b1 = ops.paged_kv_attention_chunk(*args, bits=bits)
        extra = {"max_abs_err_vs_b1": float((out - b1).abs().max()),
                 "launches": launches}
        ok = ok and torch.allclose(out, b1, rtol=1e-5, atol=1e-5)
        vs_b1 = f", {extra['max_abs_err_vs_b1']:.3e} vs B1 (tol 1e-5)"
    if not ok:
        raise AssertionError(f"kernel vs plain bits={bits} S={S} block_kv="
                             f"{block_kv}: max abs err {err:.3e} (tol {TOL})"
                             f"{vs_b1}")

    flush = flush_fn()
    ms = cuda_ms(lambda: chunk(*args, bits=bits, block_kv=block_kv),
                 reps=20, flush=flush)
    wrapper_ms = host_ms(lambda: chunk(*args, bits=bits, block_kv=block_kv))
    plain_ms = cuda_ms(lambda: pka.paged_kv_attention_chunk_plain(
        *args, bits=bits), reps=5, flush=flush)
    lib_err, library_ms = sdpa_yardstick(args, bits=bits, plain=plain,
                                         flush=flush)
    bound_ms, bound_by, nbytes, flops = attention_bound(args, kv_len, out)
    return {"bits": bits, "S": S, "B": B, "kv_len_min": int(kv_len.min()),
            "kv_len_max": int(kv_len.max()), "plan": plan,
            "max_abs_err": err, "ms": ms, "host_ms": wrapper_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bytes": nbytes, "flops": flops, **extra}


def attention_cases(rng, label: str, *, block_kv: bool = False,
                    bits_list=(0, 8, 4), keys=(1024, 2048)):
    """The served-width attention cases (pages of ``bits_list`` x decode
    and a 32-query chunk, 8 rows of ``keys`` keys), one printed line
    each."""
    cases = []
    for bits in bits_list:
        for S in (1, 32):
            c = kernel_case(rng, bits=bits, S=S, block_kv=block_kv,
                            keys=keys)
            cases.append(c)
            vs_b1 = (f", vs B1 {c['max_abs_err_vs_b1']:.2e} (tol 1e-5)"
                     if block_kv else "")
            plan = c["plan"]
            print(f"[{label}] bits={bits} S={S:>2} keys {c['kv_len_min']}-"
                  f"{c['kv_len_max']}: max_abs_err {c['max_abs_err']:.2e} "
                  f"(tol {TOL}){vs_b1}, kernel {c['ms']:.4f} ms (host "
                  f"{c['host_ms']:.4f} ms a call), plain "
                  f"{c['plain_ms']:.3f} ms, sdpa {c['library_ms']:.4f} ms, "
                  f"bound {c['bound_ms']:.4f} ms ({c['bound_by']}); "
                  f"{plan['route']} route, block_q {plan['block_q']}, "
                  f"{plan['splits']} splits, {plan['blocks_per_sm']} "
                  f"blocks/SM, {plan['smem_bytes']} B shared", flush=True)
    return cases


def kernels_phase(seed: int):
    """B1 on the six 1-2k-key cases, then at the served contexts (64-544
    keys, the served run's int8 and int4 pools)."""
    rng = np.random.default_rng(seed)
    return (attention_cases(rng, "kernel")
            + attention_cases(rng, "kernel served-ctx", bits_list=(8, 4),
                              keys=(64, 544)))


def kernel_build_report():
    """ptxas's registers, shared memory and spills for the tensor-core
    kernels (from the build's -Xptxas=-v) and the HMMA (tensor-core)
    instructions in their libraries where cuobjdump exists. Fails if B3's
    library holds no HMMA or its tensor-core kernel spills. Returns
    {library: HMMA count or None}."""
    import shutil
    from repro_torch.kernels import build

    filt = shutil.which("c++filt")
    pattern = (r"(paged_attn_mma_kernel|merge_partials_kernel|qmm_mma_kernel"
               r"|qmm_merge_kernel)(<.*>)?")
    spills = []
    for lib in ("paged_kv_attention", "quant_matmul"):
        report = build.ptxas_report(lib)
        names = [fn for fn, _, _ in report]
        if filt and names:
            names = subprocess.run([filt], input="\n".join(names),
                                   capture_output=True, text=True,
                                   check=True).stdout.splitlines()
        for name, (_, used, spill) in zip(names, report):
            short = re.search(pattern, name)
            if short:
                print(f"[ptxas] {short.group(0)}: {used}; {spill}",
                      flush=True)
                if (short.group(1) == "qmm_mma_kernel"
                        and "0 bytes spill stores" not in spill):
                    spills.append(short.group(0))
    if spills:
        raise AssertionError(f"B3's tensor-core kernel spills: {spills}")
    cuobj = (shutil.which("cuobjdump")
             or ("/usr/local/cuda/bin/cuobjdump"
                 if Path("/usr/local/cuda/bin/cuobjdump").exists() else None))
    if cuobj is None:
        print("[sass] no cuobjdump in this toolkit", flush=True)
        return {"paged_kv_attention": None, "quant_matmul": None}
    counts = {}
    for lib in ("paged_kv_attention", "quant_matmul"):
        sass = subprocess.run([cuobj, "-sass", str(build.library_path(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts[lib] = sum(" HMMA" in line for line in sass.splitlines())
        print(f"[sass] {lib} library: {counts[lib]} HMMA instructions",
              flush=True)
    if not counts["quant_matmul"]:
        raise AssertionError("B3's library holds no HMMA instruction")
    return counts


def kernel_entry(name, source, replaces, cases, main, launches):
    """One record of the kernels' JSON line; ``main`` is the case whose
    times stand for the kernel."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms"), "cases": cases}


def bound(nbytes: float, flops: float, flop_per_s: float):
    """(bound_ms, bound_by) of work that moves ``nbytes`` and does
    ``flops`` at ``flop_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kvblock_cases(rng):
    """B2 (block_kv=True) on B1's six served-width cases."""
    cases = attention_cases(rng, "B2 kvblock", block_kv=True)
    main = next(c for c in cases if c["bits"] == 8 and c["S"] == 1)
    return kernel_entry("paged_kv_attention_kvblock", SOURCE,
                        "src/repro/kernels/paged_kv_attention.py:108",
                        cases, main, sum(c["launches"] for c in cases))


def qmatmul_case(a, wq, scales, flush, *, tol):
    """One B3 case through ``kernels.ops``: its launches (the entry
    point's call alone), the route and plan it took, its error against the
    plain version relative to max|ref|, and kernel / plain /
    ``torch.matmul`` (on the dequantized weight in ``a``'s type) / bound
    times. The bound is the function's work whatever ``a``'s type: its
    bytes, or 2 M N K operations at the bf16 tensor-core rate if larger
    (a float32 ``a``'s second bf16 part is the kernel's own cost, part of
    its gap to the bound)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)

    (M, K), N = a.shape, wq.shape[1]
    name = str(a.dtype).split(".")[-1]
    quant_matmul.launches = 0               # the entry point's launch
    out = ops.qmatmul(a, wq, scales)
    launches = quant_matmul.launches
    plan = dict(quant_matmul.last_plan)
    torch.cuda.synchronize()
    if plan["route"] != "mma":
        raise AssertionError(f"qmatmul ({M}, {K}) {name} x ({K}, {N}): took "
                             f"the {plan['route']} route, not the tensor "
                             f"cores")
    plain = quant_matmul_plain(a, wq, scales)
    err = float((out - plain).abs().max())
    rel = err / float(plain.abs().max())
    if not (torch.isfinite(out).all() and rel <= tol):
        raise AssertionError(f"qmatmul ({M}, {K}) {name}: error {rel:.3e} "
                             f"of max|ref| > {tol}")
    ms = cuda_ms(lambda: quant_matmul(a, wq, scales), reps=10, flush=flush)
    plain_ms = cuda_ms(lambda: quant_matmul_plain(a, wq, scales), reps=3,
                       flush=flush)
    w_deq = (wq.float() * scales[None, :]).to(a.dtype)   # not timed
    library_ms = cuda_ms(lambda: torch.matmul(a, w_deq), reps=10,
                         flush=flush)
    del w_deq
    nbytes = (a.numel() * a.element_size() + wq.numel() * wq.element_size()
              + N * 4 + M * N * 4)
    flops = 2.0 * M * N * K
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOP_PER_S)
    c = {"M": M, "K": K, "N": N, "a_dtype": name, "launches": launches,
         "plan": plan, "max_abs_err": err, "rel_err": rel, "tol": tol,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": library_ms, "bytes": nbytes,
         "flops": flops}
    print(f"[B3 qmatmul] a ({M}, {K}) {name} x wq ({K}, {N}) int8: error "
          f"{rel:.2e} of max|ref| (tol {tol}), kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, torch.matmul {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); {plan['route']} route, "
          f"{plan['tile']} tile {plan['tile_shape']}, {plan['a_parts']} bf16 "
          f"part(s) of a, {plan['splits']} "
          f"splits, {plan['blocks_per_sm']} blocks/SM, {plan['smem_bytes']} "
          f"B shared", flush=True)
    return c


def qmatmul_cases(wq, scales):
    """B3: decode (8 rows) and prefill (256 rows) activations, bf16 and
    f32, times the served model's layer-0 up-projection grid; then a decode
    activation times a down-projection-shaped (29568, 8192) int8 grid made
    on the card from the seed (K deep and N narrow: the case split-K is
    for)."""
    import torch

    K, N = wq.shape
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    flush = flush_fn()
    cases = []
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for M in (8, 256):
            a = torch.randn((M, K), generator=g, device="cuda").to(dt)
            cases.append(qmatmul_case(a, wq, scales, flush, tol=tol))
    w_down = torch.randint(-128, 128, (N, K), generator=g, device="cuda",
                           dtype=torch.int8)
    s_down = torch.full((K,), 2.0 ** -6, dtype=torch.float32, device="cuda")
    a = torch.randn((8, N), generator=g, device="cuda").to(torch.bfloat16)
    cases.append(qmatmul_case(a, w_down, s_down, flush, tol=2e-2))
    del w_down
    main = next(c for c in cases if c["M"] == 8 and c["a_dtype"] ==
                "bfloat16" and c["K"] == K)
    return kernel_entry("quant_matmul",
                        "src/repro_torch/kernels/csrc/quant_matmul.cu",
                        "src/repro/kernels/quant_matmul.py:24", cases, main,
                        sum(c["launches"] for c in cases))


def quant_cast_cases(w_up):
    """B4: the prefill residual and the MLP weight, bf16 and f32, at the
    reference bench's four formats; exact against the plain version."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_cast import quant_cast, quant_cast_plain

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    resid = torch.randn((4096, D_MODEL), generator=g, device="cuda") * 4
    flush = flush_fn()
    cases, launches = [], 0
    for what, base in (("residual", resid), ("w_up", w_up)):
        for dt in (torch.bfloat16, torch.float32):
            x = base.to(dt)
            for (i, f) in ((2, 6), (4, 4), (2, 14), (8, 8)):
                quant_cast.launches = 0         # the entry point's launch
                out = ops.quant_cast(x, i, f)
                launches += quant_cast.launches
                torch.cuda.synchronize()
                plain = quant_cast_plain(x, i, f)
                if not torch.equal(out, plain):
                    raise AssertionError(f"quant_cast {what} {dt} Q{i}.{f}: "
                                         f"not equal to the plain version")
                ms = cuda_ms(lambda: quant_cast(x, i, f), reps=10,
                             flush=flush)
                plain_ms = cuda_ms(lambda: quant_cast_plain(x, i, f), reps=3,
                                   flush=flush)
                half = 2 ** (i + f - 1)
                lib = lambda: torch.fake_quantize_per_tensor_affine(
                    x, 2.0 ** -f, 0, -half, half - 1)
                lib_err = float((lib().float() - out.float()).abs().max())
                library_ms = cuda_ms(lib, reps=10, flush=flush)
                nbytes = 2 * x.numel() * x.element_size()
                bound_ms, bound_by = bound(nbytes, 6.0 * x.numel(),
                                           FP32_FLOP_PER_S)
                name = str(dt).split(".")[-1]
                c = {"tensor": what, "shape": list(x.shape), "dtype": name,
                     "format": f"Q{i}.{f}", "max_abs_err": 0.0, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "library_max_abs_diff": lib_err, "bytes": nbytes}
                cases.append(c)
                print(f"[B4 quant_cast] {what} {tuple(x.shape)} {name} "
                      f"Q{i}.{f}: exact, kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.3f} ms, fake_quantize_per_tensor_affine "
                      f"{library_ms:.4f} ms (differs by {lib_err:.3g}), "
                      f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
            del x
    main = next(c for c in cases if c["tensor"] == "w_up" and c["dtype"] ==
                "bfloat16" and c["format"] == "Q2.6")
    return kernel_entry("quant_cast",
                        "src/repro_torch/kernels/csrc/quant_cast.cu",
                        "src/repro/kernels/quant_cast.py:21", cases, main,
                        launches)


def pack_cases(w_up):
    """B5/B6: the layer-0 up-projection, scaled to [-1, 1], on its Q1.(b-1)
    grid at b = 2, 4, 8 and 16 bits, packed and unpacked; exact against the
    plain versions, and the 4-bit words equal QuantizedTensor's packing of
    the same weight. (Unscaled, |w_up| <= 0.0221 puts every value of the
    2- and 4-bit grids at 0.) Each grid must reach its qmin and qmax."""
    import torch
    from repro_torch.core.fixedpoint import quantize
    from repro_torch.core.qtensor import QuantizedTensor
    from repro_torch.kernels import ops
    from repro_torch.kernels.pack import (pack_2d, pack_plain, unpack_2d,
                                          unpack_plain)

    w = w_up.float() / w_up.abs().max().float()
    flush = flush_fn()
    packs, unpacks, n_pack, n_unpack = [], [], 0, 0
    for bits in (2, 4, 8, 16):
        q = quantize(w, 1, bits - 1).to(torch.int32)
        lo, hi = int(q.min()), int(q.max())
        if (lo, hi) != (-2 ** (bits - 1), 2 ** (bits - 1) - 1):
            raise AssertionError(f"pack bits={bits}: the grid spans only "
                                 f"[{lo}, {hi}]")
        pack_2d.launches = 0                    # the entry point's launches
        unpack_2d.launches = 0
        words = ops.pack(q, bits)
        back = ops.unpack(words, bits)
        n_pack += pack_2d.launches
        n_unpack += unpack_2d.launches
        torch.cuda.synchronize()
        if not (torch.equal(words, pack_plain(q, bits))
                and torch.equal(back, unpack_plain(words, bits))
                and torch.equal(back, q)):
            raise AssertionError(f"pack/unpack bits={bits}: not exact")
        if bits == 4:
            qt = QuantizedTensor.from_float(w, 1, 3, pack=True)
            if not torch.equal(qt.data, words):
                raise AssertionError("pack(q, 4) != QuantizedTensor's words")
            del qt
        for kind, fn, plain_fn, x, out, acc in (
                ("pack", pack_2d, pack_plain, q, words, packs),
                ("unpack", unpack_2d, unpack_plain, words, back, unpacks)):
            ms = cuda_ms(lambda: fn(x, bits=bits), reps=10, flush=flush)
            plain_ms = cuda_ms(lambda: plain_fn(x, bits), reps=3,
                               flush=flush)
            nbytes = 4 * (x.numel() + out.numel())
            bound_ms, bound_by = bound(nbytes, 3.0 * q.numel(),
                                       FP32_FLOP_PER_S)
            acc.append({"bits": bits, "shape": list(x.shape),
                        "grid": [lo, hi], "max_abs_err": 0.0, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None,
                        "bytes": nbytes})
            print(f"[B{5 if kind == 'pack' else 6} {kind}] bits={bits:>2} "
                  f"{tuple(x.shape)} grid [{lo}, {hi}]: exact, kernel "
                  f"{ms:.4f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})", flush=True)
        del q, words, back
    del w
    main_p = next(c for c in packs if c["bits"] == 4)
    main_u = next(c for c in unpacks if c["bits"] == 4)
    src = "src/repro_torch/kernels/csrc/pack.cu"
    return (kernel_entry("pack", src, "src/repro/kernels/pack.py:30",
                         packs, main_p, n_pack),
            kernel_entry("unpack", src,
                         "src/repro/kernels/pack.py:42", unpacks, main_u,
                         n_unpack))


def bench_check():
    """The port's kernel bench (``python -m
    repro_torch.benchmarks.kernel_bench``) on the card, every stage, each
    row held to its tolerance (B2 against B1 at 1e-5, as the tests)."""
    from repro_torch.benchmarks import kernel_bench

    res = kernel_bench.run(device="cuda", verbose=False, save=False)
    worst, rows = 0.0, 0
    for stage, table in res.items():
        for key, r in table.items():
            rows += 1
            errs = [(r.get(k), tol) for k, tol in (
                ("max_err_vs_ref", TOL), ("rel_err_vs_ref", TOL),
                ("max_err_vs_gather", TOL),
                ("blocked_vs_default_err", 1e-5))]
            errs = [(e, tol) for e, tol in errs if e is not None]
            ok = all(e <= tol for e, tol in errs) and r.get(
                "roundtrip_exact", True) and r.get("matches_ref", True)
            if not ok:
                raise AssertionError(f"kernel_bench {stage} {key}: {r}")
            worst = max([worst] + [e for e, _ in errs])
    print(f"[bench] kernel_bench: {len(res)} stages, {rows} rows within "
          f"{TOL} of their oracles, B2 within 1e-5 of B1 (worst "
          f"{worst:.3g})", flush=True)


def entry_point_phase(seed: int):
    """B2-B6 through ``kernels.ops`` at qwen2-72b's widths. Each wrapper's
    count is set to 0 just before the op's call on a case's inputs and read
    just after; the comparisons and timings that follow do not count.
    Returns the kernels' records."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models.transformer import init_model
    from repro_torch.quant.apply import (quantize_param_tree,
                                         transformer_layer_names)

    entries = [kvblock_cases(np.random.default_rng(seed + 1))]
    # layer 0 of the served model: init draws embed, head, then layer by
    # layer, so a one-layer model from the same seed has the same layer 0
    cfg = dataclasses.replace(get_config("qwen2-72b"), num_layers=1)
    model = init_model(cfg, seed=seed, device="cuda")
    w_up = model.layers[0].mlp.w_up
    assert tuple(w_up.shape) == (D_MODEL, D_FF)
    policy = PrecisionPolicy.uniform(transformer_layer_names(cfg),
                                     FixedPointFormat(2, 6), None)
    tree = quantize_param_tree(model, policy, pack=False)
    wq = tree["layers"][0]["ffn"]["w_up"].data
    del tree
    scales = torch.full((D_FF,), 2.0 ** -6, dtype=torch.float32,
                        device="cuda")
    entries.append(qmatmul_cases(wq, scales))
    del wq
    entries.append(quant_cast_cases(w_up))
    entries.extend(pack_cases(w_up))
    del w_up, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for e in entries:
        if not e["launches"]:
            raise AssertionError(f"{e['name']}: no launch through ops")
    bench_check()
    return entries


# ---------------------------------------------------------------------------
# Phase 3: the served main path
# ---------------------------------------------------------------------------
class StepTimer:
    """Wraps a step function with CUDA event pairs (no synchronization),
    so per-step device times can be read after the run. ``tag`` (optional)
    labels each call from its arguments; ``ms(tag)`` is the median over
    the calls of that label."""

    def __init__(self, fn, tag=None):
        self.fn, self.tag = fn, tag
        self.pairs = []

    def __call__(self, *a, **kw):
        import torch
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.fn(*a, **kw)
        e.record()
        self.pairs.append((s, e, self.tag(*a) if self.tag else None))
        return out

    def ms(self, tag=None):
        xs = [a.elapsed_time(b) for a, b, t in self.pairs
              if tag is None or t == tag]
        return float(np.median(xs)) if xs else None

    def count(self, tag=None):
        return sum(1 for _, _, t in self.pairs if tag is None or t == tag)


def served_requests(cfg, seed: int, *, n: int = 24, lo: int = 64,
                    hi: int = 512, max_new: int = 32):
    """``n`` seeded requests of ``lo``-``hi`` prompt tokens."""
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(seed)
    lens = rng.integers(lo, hi + 1, n)
    return [Request(i, rng.integers(0, cfg.vocab_size, int(L)).astype(
        np.int32), max_new) for i, L in enumerate(lens)]


def kv_cache_bytes(srv, peak_pages: int) -> int:
    """Device bytes of the KV the run needed: a dense server's slabs, or
    a paged server's ``peak_pages`` pages (and their scales) in every
    layer's pool."""
    from repro_torch.core.paged_kv import iter_kv_pools
    if not srv.paged:
        return sum(t.numel() * t.element_size() for c in srv.caches
                   for t in c.values())
    per_page = sum(t[0].numel() * t.element_size()
                   for c in iter_kv_pools(srv.caches) for t in c.values())
    return peak_pages * per_page


def serve_once(cfg, model, *, kv_bits: int = 0, attn_impl: str, seed: int,
               forced=None, tap: bool = False, wrap=None, fused="off",
               page_size: int = PS, batch_size: int = 8, max_len: int = 576,
               trace=None, keep=None, **server_kw):
    """One served run of ``trace`` (default: the 24 seeded requests of
    :func:`served_requests`); ``wrap`` (optional) wraps the decode step
    function. ``fused="on"`` times and taps the fused step instead;
    ``page_size=0`` serves from dense slabs (stepwise prefill through the
    decode step). ``server_kw`` goes to ``BatchedServer`` (prefix cache,
    page scales, profile, metrics, pool size); a prefix cache is released
    at the end (its counters first go to ``keep["prefix"]``), and must
    hand back every page. ``keep`` (a dict) receives the server as
    ``keep["srv"]``. Returns (requests, stats, tap or None)."""
    import torch
    from repro_torch.launch.serve import BatchedServer

    reqs = (trace or served_requests)(cfg, seed)
    srv = BatchedServer(cfg, model, batch_size=batch_size, max_len=max_len,
                        kv_bits=kv_bits, page_size=page_size,
                        attn_impl=attn_impl, prefill_bucket=32,
                        fused=fused, device="cuda", **server_kw)
    keep = {} if keep is None else keep
    keep["srv"] = srv
    peak = {"pages": 0}
    if srv.paged:
        alloc = srv.allocator.alloc

        def counting_alloc():
            page = alloc()
            used = srv.allocator.num_usable - srv.allocator.num_free
            peak["pages"] = max(peak["pages"], used)
            return page
        srv.allocator.alloc = counting_alloc
    if srv.fused:
        taps = FusedTap(srv, forced) if tap or forced is not None else None
        srv._fused = StepTimer(taps or srv._fused,
                               tag=lambda *a: "decode" if a[1].shape[1] == 1
                               else "round")
    else:
        taps = (DecodeTap(srv, forced) if tap or forced is not None
                else None)
        step = taps or srv.decode
        srv.decode = StepTimer(wrap(step) if wrap else step)
        if srv._chunk_prefill is not None:
            srv._chunk_prefill = StepTimer(srv._chunk_prefill)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(r.done and r.error is None and len(r.out) == r.max_new
               for r in reqs), "a request did not finish with its tokens"
    for cache in srv.caches:
        assert all(t.is_cuda for t in cache.values()), \
            "a KV cache left the card"
    assert all(p.is_cuda for p in model.parameters())
    if srv.prefix_cache is not None:
        keep["prefix"] = prefix_counters(srv)
        assert srv.release_prefix_cache() == 0, "prefix cache page leak"
    if srv.paged:
        assert srv.allocator.num_free == srv.allocator.num_usable
    gen = sum(len(r.out) for r in reqs)
    stats = {
        "kv_bits": kv_bits, "attn_impl": attn_impl, "fused": fused,
        "page_size": page_size, "requests": len(reqs),
        "generated_tokens": gen, "wall_s": wall, "tok_per_s": gen / wall,
        "prefill_forwards": srv.prefill_forwards,
        "decode_steps": srv.decode_steps,
        "program_launches": srv.program_launches, "cycles": srv.cycles,
        "kv_bytes": kv_cache_bytes(srv, peak["pages"]),
        "peak_pages": peak["pages"] if srv.paged else None,
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30}
    if srv.fused:
        stats.update(decode_step_ms=srv._fused.ms("decode"),
                     fused_round_ms=srv._fused.ms("round"),
                     fused_rounds=srv._fused.count("round"),
                     fused_decode_calls=srv._fused.count("decode"),
                     prefill_forward_ms=None)
    else:
        stats.update(decode_step_ms=srv.decode.ms(),
                     prefill_forward_ms=(srv._chunk_prefill.ms()
                                         if srv._chunk_prefill else None))
    return reqs, stats, taps


def compare_logits(ref: DecodeTap, test: DecodeTap) -> dict:
    """Per-step logits of two teacher-forced routes on identical inputs:
    the largest |difference|, and how often the reference's top two logits
    tie exactly (bf16 logits: an argmax a rounding flip can move)."""
    import torch
    diffs, ties = [], 0
    for key, a in ref.logits.items():
        b = test.logits[key]
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"non-finite logits at {key}")
        diffs.append(float((a.float() - b.float()).abs().max()))
        top = torch.topk(a.float(), 2).values
        ties += bool(top[0] == top[1])
    return {"steps": len(diffs), "max_abs_logit_diff": max(diffs),
            "median_max_abs_logit_diff": float(np.median(diffs)),
            "top2_tied_steps": ties}


class ProfiledSteps:
    """Wraps a decode step function: a ``torch.profiler`` window (CUDA
    activity only, to keep the profiler's host cost out of the steps) over
    steps ``start`` to ``start + steps - 1``, opened and closed at a device
    sync, with the window's host wall time."""

    def __init__(self, fn, *, start: int, steps: int):
        self.fn, self.start, self.steps = fn, start, steps
        self.n, self.prof, self.t0, self.wall_s = 0, None, None, None

    def __call__(self, *a, **kw):
        import torch
        from torch.profiler import ProfilerActivity, profile
        if self.n == self.start:
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        out = self.fn(*a, **kw)
        self.n += 1
        if self.n == self.start + self.steps:
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)
        return out


def device_activity(prof):
    """A closed profiler window's device events as (name, start us, end
    us), the microseconds the device was busy (the union of their
    intervals) and (count, us) by event name. Reads kineto's events
    without building the profiler's Python event tree where it can (a
    train step of xlstm-350m launches ~170 k kernels)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    results = getattr(getattr(prof, "profiler", None), "kineto_results",
                      None)
    if results is not None:
        evs = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
               for e in results.events() if e.device_type() == cuda]
    else:
        evs = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events() if e.device_type == cuda]
    busy, by_name = 0.0, {}
    if evs:
        spans = sorted((s0, e0) for _, s0, e0 in evs)
        cur_s, cur_e = spans[0]
        for s0, e0 in spans[1:]:
            if s0 > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s0, e0
            else:
                cur_e = max(cur_e, e0)
        busy += cur_e - cur_s
    for name, s0, e0 in evs:
        d = by_name.setdefault(name, [0, 0.0])
        d[0] += 1
        d[1] += e0 - s0
    return evs, busy, by_name


def profiled(fn, n: int, tag: str, what: str) -> dict:
    """``n`` calls of ``fn`` in a ``torch.profiler`` window (CUDA activity
    only) opened and closed at a device sync: the window's host ms a call,
    the device's busy ms and idle share, the share of device time in
    GEMM kernels and the top kernels; printed under ``tag``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evs, busy, by_name = device_activity(prof)
    if not evs:
        print(f"{tag} {what}: torch.profiler recorded no device activity",
              flush=True)
        return {"window_us": wall_us, "device_events": 0}
    kernel_us = sum(t for _, t in by_name.values())
    gemm_us = sum(t for k, (_, t) in by_name.items()
                  if "gemm" in k.lower() or "cutlass" in k.lower()
                  or "nvjet" in k.lower())
    res = {"calls": n, "ms_a_call": wall_us / n / 1e3,
           "device_busy_ms_a_call": busy / n / 1e3,
           "device_idle_share": 1.0 - busy / wall_us,
           "gemm_share_of_device_time": gemm_us / kernel_us,
           "kernels_a_call": len(evs) / n,
           "top": sorted(((t / n, c // n, k[:70]) for k, (c, t)
                          in by_name.items()), reverse=True)[:5]}
    print(f"{tag} {what}, profiled over {n} calls: {res['ms_a_call']:.2f} "
          f"ms a call (host clock), device busy "
          f"{res['device_busy_ms_a_call']:.2f} ms, idle share "
          f"{res['device_idle_share']:.3f}; {res['kernels_a_call']:.0f} "
          f"device kernels a call, GEMMs "
          f"{res['gemm_share_of_device_time']:.3f} of device time",
          flush=True)
    for t, c, k in res["top"]:
        print(f"{tag}   {t / 1e3:8.3f} ms in {c:4d} x {k}", flush=True)
    return res


def decode_profile(cfg, model, seed: int, *, start: int = 8,
                   steps: int = 8) -> dict:
    """The int8 kernel-route served run again, with a profiler window over
    ``steps`` decode steps: device time by kernel, B1's share (its
    tensor-core kernel and the merge of its splits) of the device time and
    of the window, and the device's idle share of the window (1 - the
    union of kernel and copy intervals over the window's wall time)."""
    prof = {}

    def wrap(fn):
        prof["steps"] = ProfiledSteps(fn, start=start, steps=steps)
        return prof["steps"]

    serve_once(cfg, model, kv_bits=8, attn_impl="kernel", seed=seed,
               wrap=wrap)
    win = prof["steps"]
    if win.wall_s is None:
        raise AssertionError(f"the served run took fewer than "
                             f"{start + steps} decode steps")
    window_us = win.wall_s * 1e6
    evs, busy, by_name = device_activity(win.prof)
    if not evs:
        print("[profile] torch.profiler recorded no device activity on "
              "this machine", flush=True)
        return {"window_us": window_us, "device_events": 0}
    kernel_us = sum(t for _, t in by_name.values())
    b1 = {k: v for k, v in by_name.items()
          if "paged_attn" in k or "merge_partials" in k}
    b1_us = sum(t for _, t in b1.values())
    res = {"steps": steps, "window_us": window_us,
           "step_us": window_us / steps, "device_busy_us": busy,
           "device_idle_share": 1.0 - busy / window_us,
           "device_kernel_us": kernel_us, "b1_us": b1_us,
           "b1_launches": sum(n for n, _ in b1.values()),
           "b1_share_of_device_time": b1_us / kernel_us,
           "b1_share_of_window": b1_us / window_us,
           "device_events": len(evs),
           "top": sorted(((t, n, k[:80]) for k, (n, t) in by_name.items()),
                         reverse=True)[:6]}
    print(f"[profile] int8 kernel route, decode steps {start}-"
          f"{start + steps - 1}: {res['step_us'] / 1e3:.2f} ms a step "
          f"(host clock); device busy {busy / 1e3:.2f} of "
          f"{window_us / 1e3:.2f} ms, idle share "
          f"{res['device_idle_share']:.3f}; B1 {b1_us / 1e3:.3f} ms in "
          f"{res['b1_launches']} launches = "
          f"{res['b1_share_of_device_time']:.4f} of device time, "
          f"{res['b1_share_of_window']:.4f} of the window", flush=True)
    for t, n, k in res["top"]:
        print(f"[profile]   {t / 1e3:8.3f} ms in {n:4d} x {k}", flush=True)
    return res


def serve_phase(seed: int, num_layers: int):
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.models.transformer import init_model

    cfg = dataclasses.replace(get_config("qwen2-72b"), num_layers=num_layers)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] qwen2-72b d_model={cfg.d_model} heads={cfg.num_heads}/"
          f"{cfg.num_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
          f"layers={cfg.num_layers} {cfg.dtype}: init "
          f"{time.perf_counter() - t0:.1f} s, weights "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    bits_list = (8, 4)
    gather = {b: serve_once(cfg, model, kv_bits=b, attn_impl="gather",
                            seed=seed, tap=True) for b in bits_list}
    # the main path: counts zeroed just before, read just after
    paged_kv_attention_chunk.launches = 0
    kernel = {b: serve_once(cfg, model, kv_bits=b, attn_impl="kernel",
                            seed=seed) for b in bits_list}
    launches = paged_kv_attention_chunk.launches
    expect = sum(cfg.num_layers * kernel[b][1]["program_launches"]
                 for b in bits_list)
    if launches != expect:
        raise AssertionError(f"kernel launches {launches} != layers x "
                             f"programs {expect}")
    # the kernel route again, fed the gather route's tokens
    forced = {b: serve_once(cfg, model, kv_bits=b, attn_impl="kernel",
                            seed=seed, forced={r.rid: r.out
                                               for r in gather[b][0]})
              for b in bits_list}
    runs = []
    for b in bits_list:
        ref_out = [r.out for r in gather[b][0]]
        free = accuracy_gate(ref_out, [r.out for r in kernel[b][0]])
        gate = accuracy_gate(ref_out, [r.out for r in forced[b][0]])
        cmp = compare_logits(gather[b][2], forced[b][2])
        kernel[b][1].update(
            free_running_agreement=free["agreement"],
            free_running_below_floor=free["below_floor"],
            teacher_forced_agreement=gate["agreement"],
            teacher_forced_below_floor=gate["below_floor"], **cmp)
        for stats in (gather[b][1], kernel[b][1]):
            runs.append(stats)
            print(f"[serve] kv_bits={b} {stats['attn_impl']:>6}: "
                  f"{stats['tok_per_s']:.1f} tok/s, prefill fwd "
                  f"{stats['prefill_forward_ms']:.2f} ms x "
                  f"{stats['prefill_forwards']}, decode step "
                  f"{stats['decode_step_ms']:.2f} ms x "
                  f"{stats['decode_steps']}, peak "
                  f"{stats['max_memory_allocated_gib']:.2f} GiB", flush=True)
        print(f"[serve] kv_bits={b} kernel vs gather tokens: "
              f"teacher-forced agreement {gate['agreement']:.4f} "
              f"({gate['below_floor']} requests below 0.5), free-running "
              f"{free['agreement']:.4f} ({free['below_floor']} below 0.5); "
              f"logits on identical inputs differ by at most "
              f"{cmp['max_abs_logit_diff']:.4g} (median "
              f"{cmp['median_max_abs_logit_diff']:.4g}) over "
              f"{cmp['steps']} steps, {cmp['top2_tied_steps']} with the "
              f"top two logits tied", flush=True)
        if not gate["passed"]:
            raise AssertionError(f"kv_bits={b}: kernel vs gather tokens "
                                 f"fail the accuracy gate: {gate}")
    print(f"[serve] main path: {launches} kernel launches = "
          f"{cfg.num_layers} layers x "
          f"{expect // cfg.num_layers} programs", flush=True)
    fused_launches, fused_runs = fused_phase(cfg, model, seed, gather,
                                             kernel, bits_list)
    runs += fused_runs
    prefix_launches, prefix_runs = prefix_phase(cfg, model, seed)
    runs += prefix_runs
    tier_launches, tier_runs = tier_phase(cfg, model, seed)
    runs += tier_runs
    runs.append({"decode_profile": decode_profile(cfg, model, seed)})
    runs.append(dense_phase(cfg, model, seed))
    runs.append(quant_forward_phase(cfg, model, seed))
    return (launches + fused_launches + prefix_launches + tier_launches,
            runs)


def tier_only(seed: int, num_layers: int):
    """``--phase tier``: the served model and the ``[tier]`` phase alone."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_config("qwen2-72b"), num_layers=num_layers)
    model = init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    return tier_phase(cfg, model, seed)


def fused_phase(cfg, model, seed: int, gather, separate, bits_list):
    """The same 24 requests with ``fused="on"`` through the kernel route:
    one ragged program per scheduler cycle, B1 once per layer per program
    (counts zeroed just before, read just after); then the fused kernel
    route fed the separate gather route's tokens, held to the accuracy
    gate. Returns (B1 launches, run records)."""
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk

    paged_kv_attention_chunk.launches = 0
    fused = {b: serve_once(cfg, model, kv_bits=b, attn_impl="kernel",
                           seed=seed, fused="on") for b in bits_list}
    launches = paged_kv_attention_chunk.launches
    expect = sum(cfg.num_layers * fused[b][1]["program_launches"]
                 for b in bits_list)
    if launches != expect:
        raise AssertionError(f"fused: kernel launches {launches} != "
                             f"layers x programs {expect}")
    for b in bits_list:
        st = fused[b][1]
        if st["program_launches"] != st["cycles"]:
            raise AssertionError(f"fused kv_bits={b}: {st['program_launches']}"
                                 f" programs for {st['cycles']} cycles")
    forced = {b: serve_once(cfg, model, kv_bits=b, attn_impl="kernel",
                            seed=seed, fused="on",
                            forced={r.rid: r.out for r in gather[b][0]})
              for b in bits_list}
    runs = []
    for b in bits_list:
        st, sep = fused[b][1], separate[b][1]
        ref_out = [r.out for r in gather[b][0]]
        gate = accuracy_gate(ref_out, [r.out for r in forced[b][0]])
        free = accuracy_gate(ref_out, [r.out for r in fused[b][0]])
        cmp = compare_logits(gather[b][2], forced[b][2])
        st.update(teacher_forced_agreement=gate["agreement"],
                  teacher_forced_below_floor=gate["below_floor"],
                  free_running_agreement=free["agreement"], **cmp)
        runs.append(st)
        print(f"[fused] kv_bits={b} kernel: {st['tok_per_s']:.1f} tok/s "
              f"(separate {sep['tok_per_s']:.1f}), decode step "
              f"{st['decode_step_ms']:.2f} ms x {st['fused_decode_calls']} "
              f"(separate {sep['decode_step_ms']:.2f} ms x "
              f"{sep['decode_steps']}), fused round "
              f"{st['fused_round_ms']:.2f} ms x {st['fused_rounds']}, "
              f"{st['program_launches']} programs = {st['cycles']} cycles "
              f"(separate {sep['program_launches']} programs, "
              f"{sep['cycles']} cycles), peak "
              f"{st['max_memory_allocated_gib']:.2f} GiB", flush=True)
        print(f"[fused] kv_bits={b} fused kernel vs separate gather tokens: "
              f"teacher-forced agreement {gate['agreement']:.4f} "
              f"({gate['below_floor']} below 0.5), free-running "
              f"{free['agreement']:.4f}; logits differ by at most "
              f"{cmp['max_abs_logit_diff']:.4g} (median "
              f"{cmp['median_max_abs_logit_diff']:.4g}) over "
              f"{cmp['steps']} steps", flush=True)
        if not gate["passed"]:
            raise AssertionError(f"fused kv_bits={b}: fused kernel vs "
                                 f"gather tokens fail the gate: {gate}")
    print(f"[fused] main path: {launches} kernel launches = "
          f"{cfg.num_layers} layers x {expect // cfg.num_layers} programs",
          flush=True)
    return launches, runs


# ---------------------------------------------------------------------------
# Phase 3, [prefix]: the shared-prefix page cache, per-page scales, a
# per-layer KV profile and the request tracer, served through B1
# ---------------------------------------------------------------------------
SYS_LEN, N_SYS = 200, 4             # 4 system prompts of 200 tokens
EVICT_PAGES = 120                   # a pool the cache must evict from


def prefix_trace(cfg, seed: int):
    """24 requests of 32 new tokens: one of 4 shared 200-token system
    prompts plus a suffix of 16-240 tokens; requests 22 and 23 repeat the
    prompts of requests 5 and 9 exactly (full-chain hits). Token ids lie
    below the smoke config's vocabulary, so the CPU run of the smoke
    config serves the same token trace."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import Request
    vocab = get_smoke_config("qwen2-72b").vocab_size
    rng = np.random.default_rng(seed + 7)
    sys_p = [rng.integers(0, vocab, SYS_LEN).astype(np.int32)
             for _ in range(N_SYS)]
    reqs = []
    for i in range(22):
        suffix = rng.integers(0, vocab, int(rng.integers(16, 241)))
        reqs.append(Request(i, np.concatenate(
            [sys_p[i % N_SYS], suffix.astype(np.int32)]), 32))
    for i, src in ((22, 5), (23, 9)):
        reqs.append(Request(i, reqs[src].prompt.copy(), 32))
    return reqs


def kv_profile_policy(n_layers: int):
    """Layers 0 and n-1 float (bf16 pages), the others alternating Q2.2
    (int4 pages) and Q2.6 (int8 pages)."""
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.policy import LayerPolicy, PrecisionPolicy
    fmts = [None if i in (0, n_layers - 1) else
            FixedPointFormat(2, 2 if i % 2 else 6) for i in range(n_layers)]
    return PrecisionPolicy(tuple(f"layer_{i:03d}" for i in range(n_layers)),
                           tuple(LayerPolicy(None, f) for f in fmts))


class B1Capture:
    """Wraps the decode entry of B1 as the attention layer calls it: at
    decode call ``at`` and the ``layers - 1`` calls after it (one decode
    step, every layer) it keeps a copy of the inputs, pools included (the
    server rewrites them in place later)."""

    def __init__(self, fn, *, at: int, layers: int):
        self.fn, self.at, self.layers = fn, at, layers
        self.n, self.saved = 0, []

    def __call__(self, q, kp, vp, ks, vs, pt, kv_len, *, bits):
        if self.at <= self.n < self.at + self.layers:
            self.saved.append(dict(
                q=q.clone(), k_pages=kp.clone(), v_pages=vp.clone(),
                k_scale=ks.clone(), v_scale=vs.clone(), page_table=pt.clone(),
                kv_len=kv_len.clone(), bits=bits))
        self.n += 1
        return self.fn(q, kp, vp, ks, vs, pt, kv_len, bits=bits)


def check_captured_b1(saved, label: str, tag: str = "[prefix]") -> dict:
    """B1 (the decode entry on the card) against its plain version on
    each captured layer's pool, at the kernel tests' tolerance; the
    distinct page scales among the pages in use and the containers seen."""
    import torch
    from repro_torch.kernels import paged_kv_attention as pka
    if not saved:
        raise AssertionError(f"{label}: no decode step was captured")
    errs, distinct, bits = [], [], set()
    for c in saved:
        args = (c["q"], c["k_pages"], c["v_pages"], c["k_scale"],
                c["v_scale"], c["page_table"])
        out = pka.paged_kv_attention_decode(*args, c["kv_len"],
                                            bits=c["bits"])
        plain = pka.paged_kv_attention_chunk_plain(
            c["q"][:, None], *args[1:], c["kv_len"] - 1, c["kv_len"],
            bits=c["bits"])[:, 0]
        err = float((out - plain).abs().max())
        if not (bool(torch.isfinite(out).all())
                and torch.allclose(out, plain, rtol=TOL, atol=TOL)):
            raise AssertionError(f"{label}: B1 vs plain on a served pool, "
                                 f"bits={c['bits']}: max abs err {err:.3e}")
        errs.append(err)
        used = torch.unique(c["page_table"])
        used = used[used != 0].long()
        distinct.append(int(torch.unique(c["k_scale"][used]).numel()))
        bits.add(c["bits"])
    res = {"layers": len(saved), "max_abs_err": max(errs),
           "distinct_k_scales_min": min(distinct), "bits": sorted(bits)}
    print(f"{tag} {label}: B1 vs plain on the pools of one served decode "
          f"step, {len(saved)} layers, bits {res['bits']}: max abs err "
          f"{res['max_abs_err']:.2e} (tol {TOL}); distinct k scales among "
          f"the pages in use, fewest over layers: "
          f"{res['distinct_k_scales_min']}", flush=True)
    return res


class B1ChunkCapture:
    """Wraps the chunk entry of B1 as the attention layer calls it (S > 1:
    bucketed prefill): keeps a copy of the inputs of every layer's call in
    the first prefill forward of ``S`` queries a row in which a row's chunk
    starts past position 0, so its queries also see the keys of earlier
    chunks (with ``past_start=False``: the first such forward, wherever
    its rows start); ``skip`` such forwards are let pass first."""

    def __init__(self, fn, *, layers: int, S: int, past_start: bool = True,
                 skip: int = 0):
        self.fn, self.layers, self.S = fn, layers, S
        self.past_start, self.skip = past_start, skip
        self.n, self.saved = 0, []

    def __call__(self, q, kp, vp, ks, vs, pt, q_start, kv_len, *, bits):
        if (not self.saved and self.n % self.layers == 0
                and q.shape[1] == self.S
                and (not self.past_start or bool((q_start > 0).any()))):
            self.skip -= 1
        if len(self.saved) < self.layers and (self.saved or self.skip < 0):
            self.saved.append(dict(
                q=q.clone(), k_pages=kp.clone(), v_pages=vp.clone(),
                k_scale=ks.clone(), v_scale=vs.clone(), page_table=pt.clone(),
                q_start=q_start.clone(), kv_len=kv_len.clone(), bits=bits))
        self.n += 1
        return self.fn(q, kp, vp, ks, vs, pt, q_start, kv_len, bits=bits)


def check_captured_b1_chunk(saved, label: str, tag: str) -> dict:
    """B1's chunk entry on the card against its plain version on each
    captured layer's prefill chunk, at the kernel tests' tolerance (every
    query row: the server passes ``kv_len = q_start + S``, so a padded
    query's keys are written and its row defined)."""
    import torch
    from repro_torch.kernels import paged_kv_attention as pka
    if not saved:
        raise AssertionError(f"{label}: no prefill chunk past position 0 "
                             f"was captured")
    errs = []
    for c in saved:
        args = (c["q"], c["k_pages"], c["v_pages"], c["k_scale"],
                c["v_scale"], c["page_table"], c["q_start"], c["kv_len"])
        out = pka.paged_kv_attention_chunk(*args, bits=c["bits"])
        plain = pka.paged_kv_attention_chunk_plain(*args, bits=c["bits"])
        err = float((out - plain).abs().max())
        if not (bool(torch.isfinite(out).all())
                and torch.allclose(out, plain, rtol=TOL, atol=TOL)):
            raise AssertionError(f"{label}: B1 vs plain on a served prefill "
                                 f"chunk, bits={c['bits']}: max abs err "
                                 f"{err:.3e}")
        errs.append(err)
    c = saved[0]
    B, S, H, _ = c["q"].shape
    G = H // c["k_pages"].shape[2]
    res = {"layers": len(saved), "S": S, "G": G, "rows": B,
           "rows_past_0": int((c["q_start"] > 0).sum()),
           "max_q_start": int(c["q_start"].max()),
           "max_abs_err": max(errs), "bits": c["bits"]}
    print(f"{tag} {label}: B1 vs plain on one served bucketed prefill "
          f"forward, {res['layers']} layers, S = {S}, G = {G}, {B} rows "
          f"({res['rows_past_0']} past position 0, from up to "
          f"{res['max_q_start']}), bits {res['bits']}: max abs err "
          f"{res['max_abs_err']:.2e} (tol {TOL})", flush=True)
    return res


def prefix_counters(srv) -> dict:
    """The prefix cache's host counters: they depend on tokens and pages
    only, not on the model."""
    st = srv.prefix_cache.stats()
    return {"hits": st["hits"], "hit_tokens": st["hit_tokens"],
            "cow_copies": st["cow_copies"], "evictions": st["evictions"],
            "lookups": st["lookups"], "inserted_pages": st["inserted_pages"],
            "wave_dedup_pages": srv.wave_dedup_pages,
            "prefill_forwards": srv.prefill_forwards}


def cpu_prefix_counters(seed: int, **kw) -> dict:
    """The same token trace served by the smoke config on the CPU."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config("qwen2-72b")
    model = init_model(cfg, seed=seed, device="cpu")
    srv = BatchedServer(cfg, model, batch_size=8, max_len=576, kv_bits=8,
                        page_size=PS, prefill_bucket=32, prefix_cache="on",
                        device=torch.device("cpu"), **kw)
    srv.run(prefix_trace(cfg, seed))
    return prefix_counters(srv)


def prefix_phase(cfg, model, seed: int):
    """``[prefix]``: the 24-request shared-prompt trace of
    :func:`prefix_trace` through B1 with the prefix cache off and on
    (int8), per-page scales (int8 and int4) and a per-layer profile on
    both routes, the tracer on, and a pool small enough to evict. Fails
    unless every request finishes and every page comes back, B1 runs once
    per layer per program, sharing saves prefill forwards and prompt
    tokens, every teacher-forced gate passes, B1 equals its plain version
    on the pools of one captured decode step (page scales: at least 2
    distinct; the profile: all three containers), the prefix counters
    equal the smoke config's on the CPU for the same trace, and the
    at-rest bytes are the layers' containers' bytes. Returns (B1
    launches, run records)."""
    from repro_torch.core.paged_kv import caches_kv_bytes
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.models import attention
    from repro_torch.quant.apply import kv_layer_container

    t_phase = time.perf_counter()
    profile = kv_profile_policy(cfg.num_layers)
    trace_path = Path(__file__).resolve().parent / "chiprun_out" / \
        "prefix_trace.json"
    prompt_tokens = sum(len(r.prompt) - 1 for r in prefix_trace(cfg, seed))
    launches = {"n": 0}

    def run(label, *, attn_impl="kernel", capture=False, **kw):
        keep = {}
        cap = None
        if capture:
            cap = B1Capture(attention.paged_kv_attention_decode,
                            at=40 * cfg.num_layers, layers=cfg.num_layers)
            attention.paged_kv_attention_decode = cap
        paged_kv_attention_chunk.launches = 0
        try:
            reqs, st, tap = serve_once(cfg, model, attn_impl=attn_impl,
                                       seed=seed, trace=prefix_trace,
                                       keep=keep, **kw)
        finally:
            if cap is not None:
                attention.paged_kv_attention_decode = cap.fn
        n = paged_kv_attention_chunk.launches
        srv = keep["srv"]
        if attn_impl == "kernel":
            if n != cfg.num_layers * st["program_launches"]:
                raise AssertionError(f"[prefix] {label}: B1 launches {n} != "
                                     f"layers x programs "
                                     f"{cfg.num_layers} x "
                                     f"{st['program_launches']}")
            launches["n"] += n
        by = caches_kv_bytes(srv.caches)
        st.update(label=label, b1_launches=n, kv_by_container=by,
                  kv_at_rest_bytes=sum(by.values()),
                  prefilled_tokens=prompt_tokens - srv.prefix_hit_tokens
                  - srv.wave_dedup_pages * PS)
        if srv.prefix_cache is not None:
            st["prefix"] = keep["prefix"]
        print(f"[prefix] {label:<22} {st['tok_per_s']:7.1f} tok/s, decode "
              f"step {st['decode_step_ms']:.2f} ms x {st['decode_steps']}, "
              f"{st['prefill_forwards']} prefill forwards over "
              f"{st['prefilled_tokens']} prompt tokens, B1 x {n}"
              + (f", hits {st['prefix']['hits']} ({st['prefix']['hit_tokens']}"
                 f" tokens), CoW {st['prefix']['cow_copies']}, wave-dedupe "
                 f"pages {st['prefix']['wave_dedup_pages']}, evictions "
                 f"{st['prefix']['evictions']}" if "prefix" in st else ""),
              flush=True)
        return reqs, st, tap, srv, cap

    def gate(label, ref, test):
        g = accuracy_gate([r.out for r in ref], [r.out for r in test])
        print(f"[prefix] gate {label}: teacher-forced agreement "
              f"{g['agreement']:.4f} ({g['below_floor']} below 0.5), gate "
              f"0.9 -> {'pass' if g['passed'] else 'FAIL'}", flush=True)
        if not g["passed"]:
            raise AssertionError(f"[prefix] {label} fails the gate: {g}")
        return g["agreement"]

    def exact(a, b):
        return decode_agreement([r.out for r in a],
                                [r.out for r in b])["overall"]

    runs, gates = {}, {}
    off = run("int8 prefix off", kv_bits=8)
    on = run("int8 prefix on", kv_bits=8, prefix_cache="on")
    on_f = run("int8 prefix on, forced", kv_bits=8, prefix_cache="on",
               forced={r.rid: r.out for r in off[0]})
    gates["prefix_on_vs_off"] = gate("prefix on vs off (int8 kernel)",
                                     off[0], on_f[0])
    for a, b in (("prefill_forwards", "prefill_forwards"),
                 ("prefilled_tokens", "prefilled_tokens")):
        if not on[1][a] < off[1][b]:
            raise AssertionError(f"[prefix] {a}: on {on[1][a]} is not below "
                                 f"off {off[1][b]}")
    print(f"[prefix] prefix on vs off: {on[1]['prefill_forwards']} < "
          f"{off[1]['prefill_forwards']} prefill forwards, "
          f"{on[1]['prefilled_tokens']} < {off[1]['prefilled_tokens']} "
          f"prompt tokens prefilled; free-running exact agreement "
          f"{exact(off[0], on[0]):.4f}", flush=True)
    runs.update(off=off, on=on)
    scaled = {}
    for b in (8, 4):
        g = run(f"int{b} page-scale gather", attn_impl="gather", kv_bits=b,
                kv_scale="page", prefix_cache="on")
        k = run(f"int{b} page-scale kernel", kv_bits=b, kv_scale="page",
                prefix_cache="on", capture=True)
        kf = run(f"int{b} page-scale forced", kv_bits=b, kv_scale="page",
                 prefix_cache="on", forced={r.rid: r.out for r in g[0]})
        gates[f"page_int{b}_kernel_vs_gather"] = gate(
            f"int{b} page-scale kernel vs gather", g[0], kf[0])
        print(f"[prefix] int{b} page-scale kernel vs gather: free-running "
              f"exact agreement {exact(g[0], k[0]):.4f}", flush=True)
        cap = check_captured_b1(k[4].saved, f"int{b} page-scale")
        if cap["distinct_k_scales_min"] < 2:
            raise AssertionError(f"[prefix] int{b} page-scale pools hold "
                                 f"fewer than 2 distinct scales")
        k[1]["captured_b1"] = cap
        scaled[b] = (g, k)
    pg = run("profile gather", attn_impl="gather", kv_profile=profile,
             prefix_cache="on")
    pk = run("profile kernel", kv_profile=profile, prefix_cache="on",
             capture=True)
    pf = run("profile forced", kv_profile=profile, prefix_cache="on",
             forced={r.rid: r.out for r in pg[0]})
    gates["profile_kernel_vs_gather"] = gate("profile kernel vs gather",
                                             pg[0], pf[0])
    print(f"[prefix] profile kernel vs gather: free-running exact agreement "
          f"{exact(pg[0], pk[0]):.4f}", flush=True)
    cap = check_captured_b1(pk[4].saved, "profile")
    if cap["bits"] != [0, 4, 8]:
        raise AssertionError(f"[prefix] the profile run's pools hold "
                             f"containers {cap['bits']}, not all three")
    pk[1]["captured_b1"] = cap
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    met = run("int8 metrics on", kv_bits=8, prefix_cache="on",
              metrics="on")
    met_f = run("int8 metrics on, forced", kv_bits=8, prefix_cache="on",
                metrics="on", forced={r.rid: r.out for r in on[0]})
    gates["metrics_on_vs_off"] = gate("metrics on vs off", on[0], met_f[0])
    print(f"[prefix] metrics on vs off: free-running exact agreement "
          f"{exact(on[0], met[0]):.4f}", flush=True)
    tracer = met[3].tracer
    tracer.export_chrome(str(trace_path))
    slo = tracer.slo_summary()
    steps = met[1]["decode_steps"]
    spans = {}
    for e in tracer.events:
        if e["ph"] == "X":
            d = spans.setdefault(e["name"], [0, 0.0])
            d[0] += 1
            d[1] += e["dur"] / 1e3
    ms = lambda v: "n/a" if v is None else f"{v * 1e3:.2f}"  # noqa: E731
    print(f"[prefix] slo_summary (metrics on, int8 kernel): TTFT p50 "
          f"{ms(slo['ttft_p50_s'])} ms p99 {ms(slo['ttft_p99_s'])} ms, TPOT "
          f"p50 {ms(slo['tpot_p50_s'])} ms p99 {ms(slo['tpot_p99_s'])} ms, "
          f"goodput {slo['goodput']} ({slo['finished']}/{slo['requests']} "
          f"finished); {len(tracer.events)} events -> {trace_path.name}",
          flush=True)
    for name, (n, tot) in sorted(spans.items()):
        print(f"[prefix] span {name:<14} x {n:4d}: {tot:9.2f} ms host, "
              f"{tot / steps:.3f} ms per decode step ({steps} steps)",
              flush=True)
    met[1].update(slo=slo, span_ms={k: v[1] for k, v in spans.items()},
                  span_counts={k: v[0] for k, v in spans.items()})
    ev = run(f"int8 {EVICT_PAGES} pages", kv_bits=8, prefix_cache="on",
             num_pages=EVICT_PAGES)
    if ev[1]["prefix"]["evictions"] < 1:
        raise AssertionError("[prefix] the small pool evicted nothing")
    # host counters against the smoke config on the CPU, same token trace
    cpu = {"static": cpu_prefix_counters(seed),
           "page": cpu_prefix_counters(seed, kv_scale="page"),
           "evict": cpu_prefix_counters(seed, num_pages=EVICT_PAGES)}
    card = {"static": [on, on_f, met, met_f, pg, pk, pf],
            "page": [x for b in (8, 4) for x in scaled[b]],
            "evict": [ev]}
    for key, rs in card.items():
        for r in rs:
            if r[1]["prefix"] != cpu[key]:
                raise AssertionError(f"[prefix] {r[1]['label']}: counters "
                                     f"{r[1]['prefix']} != CPU {cpu[key]}")
    print(f"[prefix] host counters equal the smoke config's on the CPU for "
          f"the same trace: static {cpu['static']}; page {cpu['page']}; "
          f"{EVICT_PAGES} pages {cpu['evict']}", flush=True)
    # the profile's bytes are its layers' containers' bytes: against
    # uniform int4 and uniform bf16 (float pages) it lies in between, but
    # with two of its 8 layers in bf16 (2 bytes a value) it is above
    # uniform int8 (8.5 bytes a value across the layers against 8)
    u4 = scaled[4][1][1]["kv_at_rest_bytes"]
    u8 = scaled[8][1][1]["kv_at_rest_bytes"]
    prof = pk[1]["kv_at_rest_bytes"]
    by = pk[1]["kv_by_container"]
    conts = [kv_layer_container(lp.data) for lp in profile.layers]
    per_layer = {"int4": u4 // cfg.num_layers, "int8": u8 // cfg.num_layers,
                 "fp": by["fp"] // conts.count("fp")}
    uf = per_layer["fp"] * cfg.num_layers
    want = sum(per_layer[c] for c in conts)
    if not (u4 < prof < uf and prof == want
            and by["int8"] == conts.count("int8") * per_layer["int8"]
            and by["int4"] == conts.count("int4") * per_layer["int4"]):
        raise AssertionError(f"[prefix] at-rest KV bytes: int4 {u4}, "
                             f"profile {prof} (expected {want}), int8 {u8}, "
                             f"bf16 {uf}")
    print(f"[prefix] at-rest KV bytes: uniform int4 {u4 / 2 ** 20:.1f} MiB "
          f"< profile {prof / 2 ** 20:.1f} MiB < uniform bf16 "
          f"{uf / 2 ** 20:.1f} MiB; uniform int8 {u8 / 2 ** 20:.1f} MiB "
          f"(the profile's layers: {conts.count('fp')} bf16 at twice an "
          f"int8 layer's page bytes, {conts.count('int8')} int8, "
          f"{conts.count('int4')} int4 at half)", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"[prefix] main path: {launches['n']} B1 launches = layers x "
          f"programs over the kernel runs; phase {wall:.1f} s", flush=True)
    out = [dict(r[1], phase="prefix") for r in
           (off, on, scaled[8][0], scaled[8][1], scaled[4][0], scaled[4][1],
            pg, pk, met, ev)]
    out.append({"phase": "prefix", "gates": gates, "cpu_counters": cpu,
                "kv_at_rest_bytes": {"int4": u4, "profile": prof,
                                     "int8": u8, "bf16": uf},
                "phase_s": wall})
    return launches["n"], out


# ---------------------------------------------------------------------------
# Phase 3, [tier]: the tiered page store (host tier, sync and async pager,
# quant tier, prefix snapshots) and SLO scheduling with preemption, on the
# bursty two-tenant trace, served through B1
# ---------------------------------------------------------------------------
TIER_PAGES = 160            # from the CPU rehearsal: >= 2 preemptions,
#                             >= 8 demotions, >= 8 promotions at int8
TIER_ADAPT_PAGES = 96       # the quant tier narrows, deepens and restores
TIER_MAX_LEN = 640


def tier_trace_config():
    """A chat service behind 4 shared 200-token system prompts sharing
    its card with long-running batch jobs: bursty arrivals over 96 decode
    steps at qwen2-72b's vocabulary."""
    from repro_torch.core.traffic import TenantSpec, TraceConfig
    return TraceConfig(
        seed=7, horizon=96, rate=0.15, process="bursty", burst_rate=2.0,
        p_enter_burst=0.10, p_exit_burst=0.30, vocab_size=152064,
        tenants=(
            TenantSpec("interactive", weight=0.7, priority=5,
                       deadline_slack=8, prompt_mean=64, prompt_sigma=0.5,
                       prompt_cap=240, max_new_mean=8, max_new_cap=16,
                       shared_prefix_len=200, prefix_pool=4),
            TenantSpec("batch", weight=0.3, priority=0, deadline_slack=None,
                       prompt_mean=256, prompt_sigma=0.5, prompt_cap=512,
                       max_new_mean=48, max_new_cap=64)))


def tier_requests(trace, vocab=None):
    """Fresh requests of ``trace``. ``vocab`` maps the token ids into a
    smaller vocabulary position by position (an id's rank among the
    distinct ids the trace has at that position): equal tokens at equal
    positions stay equal and unequal ones unequal, and that is all the
    prefix cache, the wave dedupe and the scheduler compare, so the host
    counters of the mapped trace are those of the trace."""
    from repro_torch.benchmarks.traffic import to_requests
    reqs = to_requests(trace)
    return reqs if vocab is None else map_vocab(reqs, vocab)


def map_vocab(reqs, vocab):
    """``reqs`` with their prompts' token ids mapped into ``vocab`` ids
    position by position (an id's rank among the distinct ids the
    requests have at that position), in place: equal tokens at equal
    positions stay equal and unequal ones unequal."""
    seen = {}
    for r in reqs:
        for p, t in enumerate(r.prompt):
            seen.setdefault(p, set()).add(int(t))
    rank = {p: {t: i for i, t in enumerate(sorted(ts))}
            for p, ts in seen.items()}
    if max(len(v) for v in rank.values()) > vocab:
        raise ValueError("the trace has more distinct ids at a position "
                         "than the vocabulary holds")
    for r in reqs:
        r.prompt = np.array([rank[p][int(t)] for p, t in
                             enumerate(r.prompt)], np.int32)
    return reqs


TIER_BASE = dict(batch_size=8, max_len=TIER_MAX_LEN, page_size=PS,
                 prefill_bucket=32, metrics="on")
TIER_SERVED = dict(prefix_cache="on", kv_offload="host", sched="slo",
                   num_pages=TIER_PAGES)
TIER_RUNS = {
    # name: (server options, reference run)
    "b": (dict(kv_bits=8, pager_async="off"), "a8"),
    "c": (dict(kv_bits=8, pager_async="on"), "a8"),
    "d": (dict(kv_bits=4, pager_async="on"), "a4"),
    "e": (dict(kv_bits=0, pager_async="on", kv_adapt="on",
               adapt_pages=TIER_ADAPT_PAGES), "a0"),
    "f": (dict(kv_bits=8, pager_async="on", predictor="on"), "a8"),
    "g": (dict(kv_bits=8, pager_async="on"), "a8"),
}


def tier_counters(srv) -> dict:
    """The host counters of a [tier] run: they depend on the prompts,
    lengths, arrivals and pool, not on the model's numbers."""
    st, m = srv.prefix_cache.stats(), srv.metrics
    return {
        "preempt_count": srv.preempt_count,
        "resume_count": srv.resume_count,
        "realias_skipped": srv.realias_skipped,
        "demotions": srv.pager.demotions, "promotions": srv.pager.promotions,
        "prefetches": srv.pager.prefetches,
        "prefetch_hits": srv.pager.prefetch_hits,
        "host_drops": st["host_drops"], "requants": st["requants"],
        "deepens": st["deepens"], "tier_promotions": st["tier_promotions"],
        "defers": m.counter("sched.defers").value,
        "rejects": m.counter("sched.rejects").value,
        "ooo_admissions": srv.scheduler.ooo_admissions,
        "gated": srv.predictor.gated if srv.predictor else 0,
        "prefill_forwards": srv.prefill_forwards,
        "programs": srv.program_launches, "decode_steps": srv.decode_steps,
        "hits": st["hits"], "restored_pages": st["restored_pages"],
        "staged_resumes": srv.pager.staged_resumes}


def cpu_tier_counters(seed: int, snapshot_dir: str, src: str) -> dict:
    """Runs (b)-(g) on the CPU with the smoke config cut to one layer (the
    counters do not depend on the model) and the trace mapped into its
    vocabulary, through the gather route; (g) restores the CPU's own (c)
    snapshot. Runs in a child process beside the card runs (``src`` is
    the port's source directory) on one thread: the card runs are
    host-bound, and 4 threads here took the references from 120-150 to
    85 tok/s (an H100 host of 8 cores)."""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core.traffic import generate_trace
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.transformer import init_model
    cfg = dataclasses.replace(get_smoke_config("qwen2-72b"), num_layers=1)
    model = init_model(cfg, seed=seed, device="cpu")
    trace = generate_trace(tier_trace_config())
    path = str(Path(snapshot_dir) / "cpu_c")
    out = {}
    for name, (kw, _) in TIER_RUNS.items():
        srv = BatchedServer(cfg, model, attn_impl="gather",
                            device=torch.device("cpu"),
                            **TIER_BASE, **TIER_SERVED, **kw)
        if name == "g":
            srv.restore_prefix_cache(path)
        srv.run(tier_requests(trace, cfg.vocab_size))
        out[name] = tier_counters(srv)
        if name == "c":
            srv.snapshot_prefix_cache(path)
    return out


class ForceTokens:
    """Wraps a decode step: request rid consumes the reference run's token
    g - 1 at its step g > 0 (teacher forcing; no logits are kept)."""

    def __init__(self, srv, fn, forced):
        self.srv, self.fn, self.forced = srv, fn, forced

    def __call__(self, model, tokens, pos, caches, page_table):
        import torch
        srv = self.srv
        idx = [i for i, r in enumerate(srv.slots)
               if r is not None and srv.slot_gen[i] > 0]
        if idx:
            tokens = tokens.clone()
            tokens[idx] = torch.tensor(
                [self.forced[srv.slots[i].rid][srv.slot_gen[i] - 1]
                 for i in idx], dtype=tokens.dtype, device=tokens.device)
        return self.fn(model, tokens, pos, caches, page_table)


class RestoredPages:
    """Pages the run wrote back from a tier since their allocation: host
    promotions and resumes (``pager.promote`` / ``pager.resume``) in
    ``host``, quant tier restores in ``tier``; an allocation clears a page
    from both."""

    def __init__(self, srv):
        self.host, self.tier = set(), set()
        alloc = srv.allocator.alloc

        def alloc_w():
            p = alloc()
            self.host.discard(p)
            self.tier.discard(p)
            return p

        def into(pages, fn):
            def wrapped(*a):
                p = fn(*a)
                pages.add(p)
                return p
            return wrapped

        srv.allocator.alloc = alloc_w
        srv.pager.promote = into(self.host, srv.pager.promote)
        srv.pager.resume = into(self.host, srv.pager.resume)
        if srv.quant_tier is not None:
            restore = srv.quant_tier.restore

            def restore_w(h, page):
                restore(h, page)
                self.tier.add(page)
            srv.quant_tier.restore = restore_w


class TierCapture:
    """Wraps B1's decode entry as the attention layer calls it: at the
    first decode step whose page table holds a page ``want()`` names, it
    keeps a copy of every layer's inputs (the server rewrites the pools in
    place later). Reads the server's host page table: no device sync."""

    def __init__(self, fn, srv, want, layers: int):
        self.fn, self.srv, self.want, self.layers = fn, srv, want, layers
        self.n, self.start, self.saved = 0, None, []

    def __call__(self, q, kp, vp, ks, vs, pt, kv_len, *, bits):
        if (self.start is None and self.n % self.layers == 0
                and set(self.srv.page_table.ravel().tolist()) & self.want()):
            self.start = self.n
        if self.start is not None and self.n < self.start + self.layers:
            self.saved.append(dict(
                q=q.clone(), k_pages=kp.clone(), v_pages=vp.clone(),
                k_scale=ks.clone(), v_scale=vs.clone(), page_table=pt.clone(),
                kv_len=kv_len.clone(), bits=bits))
        self.n += 1
        return self.fn(q, kp, vp, ks, vs, pt, kv_len, bits=bits)


class RoundTrip:
    """Wraps (c)'s pager: each demoted page's bytes and scales, every
    layer, captured before the demote; at its promote the new page must
    hold them, and whether the old page was rewritten meanwhile (by a
    later owner) is recorded."""

    def __init__(self, srv):
        from repro_torch.core.paged_kv import iter_kv_pools
        self.checked, self.rewritten = 0, 0
        saved = {}
        demote, promote = srv.pager.demote, srv.pager.promote

        def state(page):
            return [{k: t[page].clone() for k, t in p.items()}
                    for p in iter_kv_pools(srv.caches)]

        def demote_w(page):
            before = state(page)
            h = demote(page)
            saved[h] = (page, before)
            return h

        def promote_w(h):
            new = promote(h)
            if h in saved:
                old, before = saved.pop(h)
                now_old, now_new = state(old), state(new)
                for want, got in zip(before, now_new):
                    for k in want:
                        if not bool((want[k] == got[k]).all()):
                            raise AssertionError(
                                f"[tier] page {old} -> {new}: {k} changed "
                                f"across the async host round trip")
                self.checked += 1
                self.rewritten += any(
                    not bool((want[k] == got[k]).all())
                    for want, got in zip(before, now_old) for k in want)
            return new
        srv.pager.demote, srv.pager.promote = demote_w, promote_w


TIER_BUDGET_S = 60          # the phase's time budget on the card


def tier_phase(cfg, model, seed: int):
    """``[tier]``: the trace of :func:`tier_trace_config` through B1 with
    the page size 16, batch 8, bucketed prefill (bucket 32) and ``max_len``
    640, metrics on: (a) uninterrupted roomy FIFO references at int8, int4
    and bf16; then, each teacher-forced by its reference's tokens, (b) int8
    with SLO scheduling, host offload and the prefix cache, sync pager;
    (c) as (b) with the async pager; (d) int4 as (c); (e) a bf16 pool with
    the quant tier; (f) int8 as (c) with the predictor; (g) a fresh server
    restoring (c)'s prefix snapshot. The CPU rehearsal runs in a child
    process meanwhile. Fails unless every request finishes and every page
    comes back (host tier empty, no prefix pages held), B1 runs once per
    layer per program, (b)-(g) pass the gate against their reference,
    their host counters equal the CPU rehearsal's, (c)'s tokens equal
    (b)'s and its counters too but for the prefetches, every page demoted
    async in (c) promotes back with its bytes (at least one over a
    rewritten page), and B1 equals its plain version on pools captured
    after promotions and quant-tier restores. Returns (B1 launches, run
    records)."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    import torch
    from repro_torch.core.traffic import generate_trace, trace_fingerprint
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import attention

    t_phase = time.perf_counter()
    trace = generate_trace(tier_trace_config())
    print(f"[tier] trace: {len(trace.requests)} requests "
          f"({sum(r.tenant == 'interactive' for r in trace.requests)} "
          f"interactive), {sum(len(r.prompt) for r in trace.requests)} "
          f"prompt tokens, {sum(r.max_new for r in trace.requests)} new "
          f"tokens, overload_ratio(8) {trace.overload_ratio(8):.3f}, "
          f"fingerprint {trace_fingerprint(trace)[:16]}; pool "
          f"{TIER_PAGES} pages, quant tier {TIER_ADAPT_PAGES} floor pages",
          flush=True)
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    snap_dir = tempfile.mkdtemp(prefix="tier_snap_")
    snap = str(Path(snap_dir) / "card_c")
    launches = {"n": 0}

    def run(label, *, forced=None, capture=None, roundtrip=False,
            restore=None, snapshot=None, **kw):
        srv = BatchedServer(cfg, model, attn_impl="kernel", device="cuda",
                            **TIER_BASE, **kw)
        if restore:
            srv.restore_prefix_cache(restore)
        step = srv.decode
        if forced is not None:
            step = ForceTokens(srv, step, forced)
        srv.decode = StepTimer(step)
        pages = RestoredPages(srv) if srv.pager else None
        cap = None
        if capture is not None:
            cap = TierCapture(attention.paged_kv_attention_decode, srv,
                              lambda: getattr(pages, capture),
                              cfg.num_layers)
            attention.paged_kv_attention_decode = cap
        rt = RoundTrip(srv) if roundtrip else None
        reqs = tier_requests(trace)
        paged_kv_attention_chunk.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            srv.run(reqs)
            torch.cuda.synchronize()
        finally:
            if cap is not None:
                attention.paged_kv_attention_decode = cap.fn
        wall = time.perf_counter() - t0
        n = paged_kv_attention_chunk.launches
        if n != cfg.num_layers * srv.program_launches:
            raise AssertionError(f"[tier] {label}: B1 launches {n} != layers"
                                 f" x programs {srv.program_launches}")
        launches["n"] += n
        if not all(r.done and r.error is None and len(r.out) == r.max_new
                   for r in reqs):
            raise AssertionError(f"[tier] {label}: a request did not finish")
        gen = sum(len(r.out) for r in reqs)
        slo = srv.tracer.slo_summary()
        st = {"label": label, "requests": len(reqs), "wall_s": wall,
              "tok_per_s": gen / wall, "decode_step_ms": srv.decode.ms(),
              "decode_steps": srv.decode_steps, "b1_launches": n,
              "programs": srv.program_launches,
              "ttft_p50_s": slo.get("ttft_p50_s"),
              "ttft_p99_s": slo.get("ttft_p99_s"),
              "tpot_p50_s": slo.get("tpot_p50_s"),
              "tpot_p99_s": slo.get("tpot_p99_s"),
              "goodput": slo.get("goodput")}
        if srv.pager is not None:
            st["counters"] = tier_counters(srv)
            inv = srv.kv_inventory()
            st["inventory"] = {k: inv[k] for k in (
                "device_by_container", "host_bytes", "host_pages",
                "host_by_container", "tier_bytes", "tier_pages",
                "tier_by_container", "host_pinned_bytes")}
            st["host_peak_bytes"] = srv.host_store.peak_bytes
            st["host_s"] = {f"{tier}.{k}": srv.metrics.histogram(
                f"{tier}.{k}_s").summary() for tier, ks in (
                    ("pager", ("demote", "promote", "offload")),
                    ("tier", ("requantize", "deepen", "restore")))
                for k in ks}
            if snapshot:
                st["snapshot_pages"] = srv.snapshot_prefix_cache(snapshot)
            if rt is not None:
                st["round_trips"] = (rt.checked, rt.rewritten)
                srv.tracer.export_chrome(str(out_dir / "tier_trace.json"))
            if srv.release_prefix_cache() != 0:
                raise AssertionError(f"[tier] {label}: prefix page leak")
            if srv.host_store.num_pages != 0:
                raise AssertionError(f"[tier] {label}: the host tier kept "
                                     f"{srv.host_store.num_pages} pages")
        if srv.allocator.num_free != srv.allocator.num_usable:
            raise AssertionError(f"[tier] {label}: device page leak")
        ms = lambda v: "n/a" if v is None else f"{v * 1e3:.2f}"  # noqa: E731
        c = st.get("counters", {})
        print(f"[tier] {label:<24} {st['tok_per_s']:7.1f} tok/s, decode step "
              f"{st['decode_step_ms']:.2f} ms x {st['decode_steps']}, B1 x "
              f"{n}, TTFT p50/p99 {ms(st['ttft_p50_s'])}/"
              f"{ms(st['ttft_p99_s'])} ms, TPOT p50/p99 "
              f"{ms(st['tpot_p50_s'])}/{ms(st['tpot_p99_s'])} ms"
              + (f"; {c}" if c else ""), flush=True)
        return reqs, st, cap

    def gate(label, ref, test):
        g = accuracy_gate([r.out for r in ref], [r.out for r in test])
        print(f"[tier] gate {label}: teacher-forced agreement "
              f"{g['agreement']:.4f} ({g['below_floor']} below 0.5) -> "
              f"{'pass' if g['passed'] else 'FAIL'}", flush=True)
        if not g["passed"]:
            raise AssertionError(f"[tier] {label} fails the gate: {g}")
        return g["agreement"]

    src = str(Path(__file__).resolve().parent / "src")
    rehearsal = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_future = rehearsal.submit(cpu_tier_counters, seed, snap_dir, src)
        refs = {f"a{b}": run(f"(a) ref int{b}" if b else "(a) ref bf16",
                             kv_bits=b) for b in (8, 4, 0)}
        extras = {"c": dict(roundtrip=True, capture="host", snapshot=snap),
                  "d": dict(capture="host"), "e": dict(capture="tier"),
                  "g": dict(restore=snap)}
        runs, gates = {}, {}
        for name, (kw, ref) in TIER_RUNS.items():
            forced = {r.rid: r.out for r in refs[ref][0]}
            runs[name] = run(f"({name}) forced", forced=forced,
                             **TIER_SERVED, **kw, **extras.get(name, {}))
            gates[name] = gate(f"({name}) vs {ref}", refs[ref][0],
                               runs[name][0])
        t_card = time.perf_counter() - t_phase
        cpu = cpu_future.result()
    finally:
        rehearsal.shutdown(wait=True, cancel_futures=True)
    for name in ("d", "e"):
        g = accuracy_gate([r.out for r in refs["a8"][0]],
                          [r.out for r in runs[name][0]])
        print(f"[tier] ({name}) against the int8 reference a8 (observed, "
              f"no limit): teacher-forced agreement {g['agreement']:.4f}",
              flush=True)
    # async against sync: the pager moves bytes and decides nothing
    rb, rc = runs["b"], runs["c"]
    cb, cc = rb[1]["counters"], rc[1]["counters"]
    skip = ("prefetches", "prefetch_hits", "staged_resumes")
    diff = {k: (cb[k], cc[k]) for k in cb if k not in skip and cb[k] != cc[k]}
    if diff:
        raise AssertionError(f"[tier] (c) async differs from (b) sync: {diff}")
    agree_bc = decode_agreement([r.out for r in rb[0]],
                                [r.out for r in rc[0]])["overall"]
    if agree_bc != 1.0:
        raise AssertionError(f"[tier] (c) async tokens differ from (b) sync "
                             f"(exact agreement {agree_bc:.4f})")
    print(f"[tier] (c) async == (b) sync in every token and every host "
          f"counter but the prefetches ({cc['prefetches']} staged: "
          f"{cc['prefetch_hits']} used by prefix promotes, "
          f"{cc['staged_resumes']} by resumes)", flush=True)
    for name in TIER_RUNS:
        st = runs[name][1]
        if st["counters"] != cpu[name]:
            raise AssertionError(
                f"[tier] {st['label']}: counters {st['counters']} != "
                f"CPU {cpu[name]}")
    print(f"[tier] host counters equal the smoke config's on the CPU for "
          f"the same token trace, runs (b)-(g): {cpu}", flush=True)
    rtc = rc[1]["round_trips"]
    if rtc[0] < 1 or rtc[1] < 1:
        raise AssertionError(f"[tier] (c): {rtc[0]} async round trips "
                             f"checked, {rtc[1]} over a rewritten page")
    print(f"[tier] (c) async host round trips: {rtc[0]} demoted pages "
          f"promoted back byte for byte, {rtc[1]} of them over a page a "
          f"later owner rewrote", flush=True)
    caps = {}
    for label, cap in (("(c) int8 promoted", rc[2]),
                       ("(d) int4 promoted", runs["d"][2]),
                       ("(e) bf16 quant-tier restored", runs["e"][2])):
        res = check_captured_b1(cap.saved, label, tag="[tier]")
        scales = torch.cat([c["k_scale"][torch.unique(c["page_table"])
                                         .long()] for c in cap.saved])
        res["distinct_non_unit_scales"] = int(torch.unique(
            scales[scales != 1.0]).numel())
        print(f"[tier] {label}: {res['distinct_non_unit_scales']} distinct "
              f"non-unit k scales among the pages in use", flush=True)
        if "bf16" in label and res["distinct_non_unit_scales"] < 1:
            raise AssertionError("[tier] no quant-tier scale in the bf16 "
                                 "pools B1 read")
        caps[label] = res

    def pct(st, k):
        s = st["host_s"][k]
        return ("n/a" if not s["count"] else
                f"{s['p50'] * 1e3:.3f}/{s['p99'] * 1e3:.3f} ms x "
                f"{s['count']} ({s['mean'] * s['count']:.3f} s)")
    for name in ("b", "c"):
        st = runs[name][1]
        inv = st["inventory"]
        print(f"[tier] ({name}) at rest before release: device "
              f"{inv['device_by_container']}, host {inv['host_bytes']} B in "
              f"{inv['host_pages']} pages {inv['host_by_container']} "
              f"({inv['host_pinned_bytes']} B of pinned transfer buffers), "
              f"peak host {st['host_peak_bytes']} B; pager p50/p99 demote "
              f"{pct(st, 'pager.demote')}, promote "
              f"{pct(st, 'pager.promote')}, offload "
              f"{pct(st, 'pager.offload')}", flush=True)
    st = runs["e"][1]
    inv = st["inventory"]
    print(f"[tier] (e) quant tier at rest: {inv['tier_bytes']} B in "
          f"{inv['tier_pages']} pages {inv['tier_by_container']}; host "
          f"p50/p99 requantize {pct(st, 'tier.requantize')}, deepen "
          f"{pct(st, 'tier.deepen')}, restore {pct(st, 'tier.restore')}",
          flush=True)
    wall = time.perf_counter() - t_phase
    print(f"[tier] main path: {launches['n']} B1 launches = layers x "
          f"programs over the runs; phase {wall:.1f} s against a "
          f"{TIER_BUDGET_S} s budget (card runs {t_card:.1f} s, the CPU "
          f"rehearsal beside them)", flush=True)
    out = [dict(r[1], phase="tier") for r in
           list(refs.values()) + list(runs.values())]
    out.append({"phase": "tier", "gates": gates, "cpu_counters": cpu,
                "b_c_exact_agreement": agree_bc, "captured_b1": caps,
                "requests": len(trace.requests),
                "overload_ratio": trace.overload_ratio(8),
                "num_pages": TIER_PAGES, "phase_s": wall,
                "budget_s": TIER_BUDGET_S})
    return launches["n"], out


# ---------------------------------------------------------------------------
# [moe]: the MoE and MLA families at published widths, depth cut: llama4
# served through B1 at G = 5 on paged pools, deepseek-v3 on dense latent
# caches
# ---------------------------------------------------------------------------
LLAMA4, DSV3 = "llama4-maverick-400b-a17b", "deepseek-v3-671b"
MOE_LAYERS = {LLAMA4: 2, DSV3: 4}     # one full period; 3 dense + 1 MoE
MOE_TRAFFIC = {LLAMA4: dict(n=16, lo=32, hi=160, max_new=16),
               DSV3: dict(n=8, lo=32, hi=96, max_new=16)}
MOE_SERVE = {LLAMA4: dict(batch_size=8, max_len=192, page_size=PS),
             DSV3: dict(batch_size=8, max_len=128, page_size=0)}
MOE_RUNS = {
    # label: (arch, config overrides, server options, route, forced by)
    "a": (LLAMA4, dict(moe_mode="eval_all"), dict(kv_bits=8), "gather",
          None),
    "b": (LLAMA4, dict(moe_mode="eval_all"), dict(kv_bits=8), "kernel",
          "a"),
    "c": (LLAMA4, dict(moe_mode="eval_all"), dict(kv_bits=4), "kernel",
          "a"),
    "e": (LLAMA4, dict(moe_mode="scatter"), dict(kv_bits=8), "gather",
          None),
    "d": (LLAMA4, dict(moe_mode="scatter"), dict(kv_bits=8), "kernel",
          "e"),
    "f": (DSV3, dict(moe_mode="scatter"), dict(kv_bits=0), "gather", None),
    "g": (DSV3, dict(moe_mode="scatter"), dict(kv_bits=8), "gather", None),
    "h": (DSV3, dict(moe_mode="scatter", mla_absorbed=True),
          dict(kv_bits=8), "gather", "g"),
}
MOE_GATED = {"b": "a", "d": "e", "h": "g"}   # teacher-forced gates
# the stepwise scatter runs take the 8 shortest prompts of the trace:
# stepwise prefill spends a program on each prompt token
MOE_SHORT = {"d", "e"}
MOE_BUDGET_S = 60
# the first requests of run (d), served plain and on a one-rank NCCL
# mesh; the mesh run's decode step captured
MOE_MESH, MOE_MESH_DECODE_AT, MOE_MESH_REQUESTS = "d", 6, 2


def moe_trace(label, seed: int, vocab=None):
    """Run ``label``'s requests, drawn in its arch's published vocabulary
    (the 8 shortest prompts only for a run in ``MOE_SHORT``); ``vocab``
    maps them into a smaller one position by position
    (:func:`map_vocab`)."""
    from repro_torch.configs.registry import get_config
    arch = MOE_RUNS[label][0]
    reqs = served_requests(get_config(arch), seed + 3, **MOE_TRAFFIC[arch])
    if label in MOE_SHORT:
        short = sorted(reqs, key=lambda r: len(r.prompt))[:8]
        reqs = sorted(short, key=lambda r: r.rid)
    return reqs if vocab is None else map_vocab(reqs, vocab)


def moe_counters(srv) -> dict:
    """A [moe] run's host counters: prompts and pages decide them."""
    c = {"prefill_mode": srv.prefill_mode,
         "prefill_forwards": srv.prefill_forwards,
         "prefill_tokens": srv.prefill_tokens,
         "decode_steps": srv.decode_steps,
         "programs": srv.program_launches, "cycles": srv.cycles}
    if srv.paged:
        c.update(allocs=srv.metrics.value("alloc.allocs"),
                 usable=srv.allocator.num_usable)
    return c


def cpu_moe_counters(seed: int, src: str) -> dict:
    """Every [moe] run's server on the CPU with the arch's smoke config
    (its moe_mode and MLA route set as the run's), the trace mapped into
    its vocabulary, through the gather route (the counters do not depend
    on the route or the model). Runs in a child process beside the card
    runs (``src`` is the port's source directory), on one thread."""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.transformer import init_model
    out, seen = {}, {}
    for label, (arch, over, kw, _, _) in MOE_RUNS.items():
        key = (arch, tuple(sorted(over.items())), tuple(sorted(kw.items())),
               label in MOE_SHORT)
        if key not in seen:
            cfg = dataclasses.replace(get_smoke_config(arch), **over)
            model = init_model(cfg, seed=seed, device="cpu")
            srv = BatchedServer(cfg, model, attn_impl="gather",
                                prefill_bucket=32, device="cpu",
                                **MOE_SERVE[arch], **kw)
            srv.run(moe_trace(label, seed, cfg.vocab_size))
            seen[key] = moe_counters(srv)
        out[label] = seen[key]
    return out


def moe_model(arch, seed: int):
    """The arch at published widths cut to ``MOE_LAYERS`` layers, bf16,
    random weights from a seeded generator; prints the cut."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_model
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS[arch])
    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    kinds = ", ".join(f"{i}: {'MoE' if blk.sig[1] == 'moe' else 'dense'}"
                      for i, blk in enumerate(model.layers))
    attn = (f"MLA q_lora {cfg.q_lora_rank} kv_lora {cfg.kv_lora_rank} "
            f"rope {cfg.qk_rope_head_dim}" if cfg.attention_type == "mla"
            else f"GQA G = {cfg.num_heads // cfg.num_kv_heads}, "
            f"head_dim {cfg.head_dim}")
    n = sum(p.numel() for p in model.parameters())
    print(f"[moe] {arch}: published widths (d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, {attn}, d_ff "
          f"{cfg.d_ff}, {cfg.num_experts} experts of {cfg.moe_d_ff} top-"
          f"{cfg.experts_per_token}"
          f"{' sigmoid' if cfg.moe_sigmoid_router else ''} + "
          f"{cfg.num_shared_experts} shared, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}); cut: depth {full.num_layers} -> "
          f"{cfg.num_layers} layers ({kinds})"
          f"{', the MTP block carried' if model.mtp is not None else ''}; "
          f"{n / 1e9:.2f} G parameters, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, model


def moe_arch_runs(arch, seed: int, runs: dict, caps: dict) -> int:
    """The [moe] runs of ``arch`` on one model (see :func:`moe_phase`),
    recorded in ``runs`` (label -> (requests, stats, None)) and ``caps``
    (label -> B1 against plain on captured pools). Returns the B1
    launches. The model, servers and taps die with the call."""
    import torch
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.models import attention

    cfg, model = moe_model(arch, seed)
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    labels = [lb for lb, r in MOE_RUNS.items() if r[0] == arch]
    # one short untimed run of the first run's kind first, so that no
    # timed run pays the card's one-time costs (kernels loaded on first
    # use, cuBLAS workspaces, the caching allocator's first blocks)
    t0 = time.perf_counter()
    warm = moe_trace(labels[0], seed)[:2]
    for r in warm:
        r.max_new = 2
    serve_once(dataclasses.replace(cfg, **MOE_RUNS[labels[0]][1]), model,
               attn_impl=MOE_RUNS[labels[0]][3], seed=seed,
               trace=lambda c, sd: warm, **MOE_SERVE[arch],
               **MOE_RUNS[labels[0]][2])
    print(f"[moe] {arch}: untimed warm-up run (2 requests of 2 new tokens "
          f"as ({labels[0]})) {time.perf_counter() - t0:.2f} s", flush=True)
    launches, taps = 0, {}
    for label in labels:
        _, over, kw, impl, by = MOE_RUNS[label]
        rcfg = dataclasses.replace(cfg, **over)
        cap = chunk_cap = None
        if impl == "kernel" and by == "a":
            cap = B1Capture(attention.paged_kv_attention_decode,
                            at=6 * cfg.num_layers, layers=cfg.num_layers)
            attention.paged_kv_attention_decode = cap
            chunk_cap = B1ChunkCapture(attention.paged_kv_attention_chunk,
                                       layers=cfg.num_layers, S=32)
            attention.paged_kv_attention_chunk = chunk_cap
        forced = {r.rid: r.out for r in runs[by][0]} if by else None
        keep = {}
        paged_kv_attention_chunk.launches = 0
        try:
            reqs, st, taps[label] = serve_once(
                rcfg, model, attn_impl=impl, seed=seed,
                trace=lambda c, sd: moe_trace(label, sd), forced=forced,
                tap=True, keep=keep, **MOE_SERVE[arch], **kw)
        finally:
            if cap is not None:
                attention.paged_kv_attention_decode = cap.fn
                attention.paged_kv_attention_chunk = chunk_cap.fn
        n = paged_kv_attention_chunk.launches
        if impl == "kernel" and n != cfg.num_layers * st["program_launches"]:
            raise AssertionError(f"[moe] ({label}): B1 launches {n} != "
                                 f"layers x programs "
                                 f"{st['program_launches']}")
        if impl == "gather" and n:
            raise AssertionError(f"[moe] ({label}): the gather route "
                                 f"launched B1 {n} times")
        launches += n
        st.update(label=label, arch=arch, b1_launches=n,
                  weights_gib=weights_gib,
                  counters=moe_counters(keep["srv"]),
                  moe_mode=rcfg.moe_mode, mla_absorbed=rcfg.mla_absorbed)
        if by:
            # the logits of the two runs on identical inputs
            st.update(compare_logits(taps[by], taps[label]))
        if cap is not None:
            what = (f"({label}) kv_bits={kw['kv_bits']} G="
                    f"{cfg.num_heads // cfg.num_kv_heads}")
            caps[label] = {
                "decode": check_captured_b1(cap.saved, what, tag="[moe]"),
                "prefill": check_captured_b1_chunk(chunk_cap.saved, what,
                                                   tag="[moe]")}
        runs[label] = (reqs, st, None)
        print(f"[moe] ({label}) {arch} {rcfg.moe_mode}"
              f"{' absorbed' if rcfg.mla_absorbed else ''} "
              f"kv_bits={kw['kv_bits']} {impl}"
              f"{f' forced by ({by})' if by else ''}: "
              f"{st['tok_per_s']:.1f} tok/s, decode step "
              f"{st['decode_step_ms']:.2f} ms x {st['decode_steps']}, B1 x "
              f"{n}, peak {st['max_memory_allocated_gib']:.2f} GiB "
              f"(weights {weights_gib:.2f}); {st['counters']}"
              + (f"; logits vs ({by}) on identical inputs differ by at "
                 f"most {st['max_abs_logit_diff']:.4g} (median "
                 f"{st['median_max_abs_logit_diff']:.4g}, "
                 f"{st['top2_tied_steps']} steps with the top two tied)"
                 if by else ""), flush=True)
    if arch == LLAMA4:
        n, caps[f"{MOE_MESH} mesh"] = moe_mesh_check(cfg, model, seed, runs)
        launches += n
    return launches


def host_counters(srv) -> dict:
    """Every counter of a server's registry but the timers."""
    return {k: v for k, v in srv.metrics.snapshot()["counters"].items()
            if not k.endswith("_s")}


def mesh_arm(tag: str, what: str, cfg, model, *, seed: int, trace,
             impl: str, forced=None, decode_at: int = 6,
             **serve_kw) -> tuple:
    """``what`` (a served prefix of one of the phase's runs: ``trace``)
    on a mesh: served by the plain server, then by
    ``BatchedServer(mesh=make_serving_mesh(1))`` on a one-rank NCCL group
    opened for the arm (its start and its first collective, NCCL's
    one-time cost, untimed before the run), on the same model and
    options, teacher-forced alike: the mesh server's tokens and every
    host counter bit for bit the plain server's, every parameter of its
    model a view of the plain model's (no second copy of the weights),
    and, on the kernel route, B1 against its plain version on one
    captured decode step of the mesh run, every attention layer. A
    prefix, not the whole run: two short runs cost less than one long
    one. Returns (B1 launches over both runs, record)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import attention
    n_attn = sum(blk.sig[0] == "attn" for blk in model.layers)
    keep = {}
    t0 = time.perf_counter()
    paged_kv_attention_chunk.launches = 0
    want, wst, _ = serve_once(cfg, model, attn_impl=impl, seed=seed,
                              trace=trace, forced=forced, keep=keep,
                              **serve_kw)
    n = paged_kv_attention_chunk.launches
    want_counters = host_counters(keep["srv"])
    keep.clear()
    t_plain = time.perf_counter() - t0
    cap = None
    if impl == "kernel" and n_attn:
        cap = B1Capture(attention.paged_kv_attention_decode,
                        at=decode_at * n_attn, layers=n_attn)
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    mesh = make_serving_mesh(1, device="cuda")
    backend = dist.get_backend()
    try:
        first = torch.ones(1, device="cuda")
        dist.all_reduce(first)
        torch.cuda.synchronize()
        t_group = time.perf_counter() - t0
        paged_kv_attention_chunk.launches = 0
        if cap is not None:
            attention.paged_kv_attention_decode = cap
        t0 = time.perf_counter()
        reqs, st, _ = serve_once(cfg, model, attn_impl=impl, seed=seed,
                                 trace=trace, forced=forced, keep=keep,
                                 mesh=mesh, **serve_kw)
        t_mesh = time.perf_counter() - t0
    finally:
        if cap is not None:
            attention.paged_kv_attention_decode = cap.fn
        dist.destroy_process_group()
    n += paged_kv_attention_chunk.launches
    srv = keep["srv"]
    plain = dict(model.named_parameters())
    views = all(p.data_ptr() == plain[name].data_ptr()
                for name, p in srv.model.named_parameters())
    weights = sum(p.numel() * p.element_size()
                  for p in srv.model.parameters()) / 2 ** 30
    same = [list(r.out) for r in reqs] == [list(r.out) for r in want]
    counters = host_counters(srv)
    del srv, keep
    b1 = None
    if cap is not None:
        b1 = check_captured_b1(cap.saved, f"{what} on a mesh, "
                               f"make_serving_mesh(1) on {backend}, G="
                               f"{cfg.num_heads // cfg.num_kv_heads}",
                               tag=tag)
    print(f"{tag} {what} on a mesh: its first {len(reqs)} requests served "
          f"plain ({t_plain:.1f} s) and by BatchedServer(mesh="
          f"make_serving_mesh(1)) on a one-rank {backend} group "
          f"({t_mesh:.1f} s; the group's start and first collective "
          f"{t_group:.2f} s before it, untimed), {impl} kv_bits="
          f"{serve_kw.get('kv_bits', 0)} page size "
          f"{serve_kw.get('page_size', PS)}: tokens equal {same}, "
          f"{len(counters)} host counters equal "
          f"{counters == want_counters}; every parameter a view of the "
          f"plain model's {views} ({weights:.2f} GiB not copied; "
          f"{held / 2 ** 30:.2f} GiB held before the server); {n} B1 "
          f"launches over both; decode step {st['decode_step_ms']:.2f} ms "
          f"against the plain server's {wst['decode_step_ms']:.2f}",
          flush=True)
    if not (same and views and counters == want_counters):
        diff = {k: (counters.get(k), want_counters.get(k))
                for k in set(counters) | set(want_counters)
                if counters.get(k) != want_counters.get(k)}
        raise AssertionError(f"{tag} {what} on a mesh: the world-size-1 "
                             f"mesh server is not the plain server bit for "
                             f"bit (tokens {same}, views {views}, counters "
                             f"that differ {diff})")
    return n, {"label": f"{what} mesh", "arch": cfg.name,
               "phase": tag.strip("[]"), "requests": len(reqs),
               "backend": backend, "b1_launches": n, "b1_vs_plain": b1,
               "views": views, "weights_gib": weights,
               "counters": counters, "plain_s": t_plain, "mesh_s": t_mesh,
               "group_s": t_group, "decode_step_ms": st["decode_step_ms"],
               "plain_decode_step_ms": wst["decode_step_ms"],
               "tok_per_s": st["tok_per_s"],
               "plain_tok_per_s": wst["tok_per_s"]}


def moe_mesh_check(cfg, model, seed: int, runs: dict) -> tuple:
    """[moe] ``MOE_MESH`` on a mesh (:func:`mesh_arm`): the first
    ``MOE_MESH_REQUESTS`` requests of run ``MOE_MESH`` (scatter, int8
    pages, B1, teacher-forced as the plain run was), its experts split
    E / 1 over "model", each MoE layer's partial output all-reduced.
    Returns (B1 launches, record)."""
    arch, over, kw, impl, by = MOE_RUNS[MOE_MESH]
    forced = {r.rid: r.out for r in runs[by][0]} if by else None
    return mesh_arm(
        "[moe]", f"({MOE_MESH})", dataclasses.replace(cfg, **over), model,
        seed=seed, impl=impl, forced=forced, decode_at=MOE_MESH_DECODE_AT,
        trace=lambda c, sd: moe_trace(MOE_MESH, sd)[:MOE_MESH_REQUESTS],
        **MOE_SERVE[arch], **kw)


def moe_phase(seed: int):
    """``[moe]``: llama4-maverick (2 layers: a dense layer and a MoE layer
    of 128 experts top-1 plus the shared one) served on paged pools at
    page size 16, batch 8, bucket 32, 16 requests of 32-160 prompt tokens
    and 16 new: (a) eval_all int8 on the gather route, (b) the same on
    the kernel route teacher-forced by (a), (c) int4 on the kernel route
    fed (a)'s tokens, (e) the published scatter dispatch (stepwise, by
    the server's rule) int8 gather on the trace's 8 shortest prompts,
    (d) the same on the kernel route teacher-forced by (e); then
    deepseek-v3 (3 dense layers and a MoE layer of 256 experts top-8,
    sigmoid router) on dense latent caches, max_len 128, 8 requests of
    32-96 prompt tokens and 16 new, stepwise: (f) bf16 latent, (g) int8
    latent on the expanded route, (h) int8 on the absorbed route
    teacher-forced by (g); and (d)'s first requests, plain and on a
    one-rank NCCL mesh (:func:`moe_mesh_check`). One model on the card at a time, each after
    an untimed warm-up run. Fails unless every request finishes, B1 runs
    once per layer per program on the kernel runs, (b), (d) and (h) pass
    the gate, B1 equals its plain version on the pools of one captured
    decode step (S = 1) and of one captured bucketed prefill forward
    (S = 32) of (b) and (c) (G = 5) and of one decode step of (d) on the
    mesh, the mesh run is its plain run bit for bit, and every run's host counters
    equal the smoke config's on the CPU for the same trace (a child
    process). Returns (B1 launches, run records)."""
    import concurrent.futures
    import gc
    import multiprocessing

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe] card memory held before the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    src = str(Path(__file__).resolve().parent / "src")
    rehearsal = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    runs, caps, launches = {}, {}, 0
    try:
        cpu_future = rehearsal.submit(cpu_moe_counters, seed, src)
        for arch in (LLAMA4, DSV3):
            launches += moe_arch_runs(arch, seed, runs, caps)
            # the model, its servers and their taps are gone: free them
            gc.collect()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated() / 2 ** 30
            print(f"[moe] {arch} freed: {held:.2f} GiB still allocated",
                  flush=True)
            if held > 1.0:
                raise AssertionError(f"[moe] {arch}'s model stayed on the "
                                     f"card ({held:.2f} GiB)")
        t_card = time.perf_counter() - t_phase
        cpu = cpu_future.result()
    finally:
        rehearsal.shutdown(wait=True, cancel_futures=True)
    gates = {}
    for label, ref in MOE_GATED.items():
        g = accuracy_gate([r.out for r in runs[ref][0]],
                          [r.out for r in runs[label][0]])
        print(f"[moe] gate ({label}) vs ({ref}): teacher-forced agreement "
              f"{g['agreement']:.4f} ({g['below_floor']} below 0.5) -> "
              f"{'pass' if g['passed'] else 'FAIL'}", flush=True)
        if not g["passed"]:
            raise AssertionError(f"[moe] ({label}) fails the gate: {g}")
        gates[label] = g["agreement"]
    for label, ref in (("c", "a"), ("g", "f")):
        g = accuracy_gate([r.out for r in runs[ref][0]],
                          [r.out for r in runs[label][0]])
        print(f"[moe] ({label}) against ({ref}) (observed, no limit): "
              f"agreement {g['agreement']:.4f}", flush=True)
    for label, (_, st, _) in runs.items():
        if st["counters"] != cpu[label]:
            raise AssertionError(f"[moe] ({label}): counters "
                                 f"{st['counters']} != CPU {cpu[label]}")
    print(f"[moe] host counters equal the smoke configs' on the CPU for "
          f"the same token traces, runs (a)-(h)", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"[moe] main path: {launches} B1 launches = layers x programs "
          f"over the kernel runs; phase {wall:.1f} s against a "
          f"{MOE_BUDGET_S} s budget (card runs and model init "
          f"{t_card:.1f} s, the CPU rehearsal beside them)", flush=True)
    out = [dict(st, phase="moe") for _, st, _ in runs.values()]
    out.append({"phase": "moe", "gates": gates, "cpu_counters": cpu,
                "captured_b1": caps, "phase_s": wall,
                "budget_s": MOE_BUDGET_S})
    return launches, out


# ---------------------------------------------------------------------------
# [ssm]: the recurrent families at published widths: xlstm-350m and
# jamba-v0.1-52b each cut to one period, xlstm on dense states, jamba's
# attention layer served through B1 at G = 4 on paged pools
# ---------------------------------------------------------------------------
XLSTM, JAMBA = "xlstm-350m", "jamba-v0.1-52b"
# each cut to one 8-layer period (xlstm's 24 held the phase over its
# budget, and 16 still did on a slower host)
SSM_LAYERS = {XLSTM: 8, JAMBA: 8}
SSM_TRAFFIC = dict(n=8, lo=16, hi=48, max_new=16)
SSM_SERVE = {XLSTM: dict(batch_size=4, max_len=96, page_size=0),
             JAMBA: dict(batch_size=4, max_len=96, page_size=PS)}
SSM_RUNS = {
    # label: (arch, server options, route, forced by)
    "a": (XLSTM, dict(kv_bits=0), "gather", None),
    "b": (XLSTM, dict(kv_bits=8), "gather", "a"),
    "c": (JAMBA, dict(kv_bits=8), "gather", None),
    "d": (JAMBA, dict(kv_bits=8), "kernel", "c"),
    "e": (JAMBA, dict(kv_bits=4), "kernel", "c"),
}
SSM_GATED = {"d": "c"}                # teacher-forced gates
SSM_OBSERVED = {"b": "a", "e": "c"}   # teacher-forced, no limit
# alone vs batched, teacher-forced: the batched run's options, and jamba's
# MoE at exact routing (scatter's expert capacity is shared by the rows
# of a forward, so under it a request's tokens depend on its neighbours)
SSM_ALONE = {XLSTM: ("a", {}), JAMBA: ("c", dict(moe_mode="eval_all"))}
SSM_BUDGET_S = 60
# run (f), C4 on the card: jamba at exact routing on int8 pages through
# B1, SLO scheduling with the host tier and preemption, batch size 1 on a
# pool that holds one request's pages, the trace's 3 shortest requests
# (rid order) with these (new tokens, priority, arrival step): the second
# preempts the first, the third the second
SSM_PREEMPT_SERVE = dict(batch_size=1, max_len=96, page_size=PS, kv_bits=8)
SSM_PREEMPT_POOL = dict(num_pages=4, sched="slo", kv_offload="host")
SSM_PREEMPT_PLAN = ((8, 0, 0), (6, 5, 3), (4, 9, 6))
# the mesh arms (:func:`mesh_arm`): the first requests of a run, served
# plain and on a one-rank NCCL mesh; xlstm's (a) serves dense states and
# the mesh needs pages, so both servers of its arm take page size PS
SSM_MESH = {XLSTM: ("a", dict(page_size=PS)), JAMBA: ("d", {})}
SSM_MESH_REQUESTS = 2


def ssm_trace(arch, seed: int, vocab=None):
    """The phase's 8 requests in ``arch``'s published vocabulary, or
    mapped into ``vocab`` position by position (:func:`map_vocab`)."""
    from repro_torch.configs.registry import get_config
    reqs = served_requests(get_config(arch), seed + 5, **SSM_TRAFFIC)
    return reqs if vocab is None else map_vocab(reqs, vocab)


def ssm_shortest(arch, seed: int, n: int):
    """The trace's ``n`` shortest requests, in rid order (each prompt
    token costs a whole-batch program under stepwise prefill)."""
    short = sorted(ssm_trace(arch, seed), key=lambda r: len(r.prompt))[:n]
    return sorted(short, key=lambda r: r.rid)


def ssm_preempt_trace(seed: int, vocab=None):
    """Run (f)'s requests (``SSM_PREEMPT_PLAN``), in jamba's published
    vocabulary or mapped into ``vocab``."""
    from repro_torch.launch.serve import Request
    reqs = [Request(r.rid, r.prompt, n, priority=p, arrive_step=a)
            for r, (n, p, a) in zip(ssm_shortest(JAMBA, seed, 3),
                                    SSM_PREEMPT_PLAN)]
    return reqs if vocab is None else map_vocab(reqs, vocab)


def preempt_counters(srv, reqs) -> dict:
    """Run (f)'s host counters: :func:`moe_counters`, the scheduler's and
    the host tier's in pages (bytes depend on the widths), and each
    request's preemptions."""
    return dict(moe_counters(srv), preempt=srv.preempt_count,
                resume=srv.resume_count,
                defers=srv.metrics.counter("sched.defers").value,
                host_puts=srv.host_store.puts,
                host_peak=srv.host_store.peak_pages,
                preemptions=[r.preemptions for r in reqs])


def cpu_ssm_counters(seed: int, src: str) -> dict:
    """Every [ssm] run's server on the CPU with the arch's smoke config
    (the published moe_mode; run (f) at the smoke jamba's eval_all), the
    trace mapped into its vocabulary, through the gather route (the
    counters depend on prompts and pages only). Runs in a child process
    beside the card runs, on one thread."""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.transformer import init_model
    out, seen = {}, {}
    for label, (arch, kw, _, _) in SSM_RUNS.items():
        key = (arch, tuple(sorted(kw.items())))
        if key not in seen:
            cfg = dataclasses.replace(get_smoke_config(arch),
                                      moe_mode=get_config(arch).moe_mode)
            model = init_model(cfg, seed=seed, device="cpu")
            srv = BatchedServer(cfg, model, attn_impl="gather",
                                prefill_bucket=32, device="cpu",
                                **SSM_SERVE[arch], **kw)
            srv.run(ssm_trace(arch, seed, cfg.vocab_size))
            seen[key] = moe_counters(srv)
        out[label] = seen[key]
    cfg = get_smoke_config(JAMBA)
    srv = BatchedServer(cfg, init_model(cfg, seed=seed, device="cpu"),
                        attn_impl="gather", device="cpu",
                        **SSM_PREEMPT_SERVE, **SSM_PREEMPT_POOL)
    out["f"] = preempt_counters(
        srv, srv.run(ssm_preempt_trace(seed, cfg.vocab_size)))
    return out


def ssm_model(arch, seed: int):
    """The arch at published widths, ``SSM_LAYERS`` layers, bf16, random
    weights from a seeded generator; prints the cut."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_model
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=SSM_LAYERS[arch])
    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    kinds = ", ".join(f"{i}: {blk.sig[0]}"
                      + ("+MoE" if blk.sig[1] == "moe" else "")
                      for i, blk in enumerate(model.layers))
    if cfg.num_experts:
        mix = (f"GQA {cfg.num_heads}/{cfg.num_kv_heads} heads (G = "
               f"{cfg.num_heads // cfg.num_kv_heads}), head_dim "
               f"{cfg.head_dim}; Mamba d_inner {cfg.ssm_expand * cfg.d_model}"
               f", state {cfg.ssm_state_dim}, head {cfg.ssm_head_dim}, "
               f"conv {cfg.ssm_conv_dim}; d_ff {cfg.d_ff}; "
               f"{cfg.num_experts} experts of {cfg.moe_d_ff} top-"
               f"{cfg.experts_per_token} {cfg.moe_mode}")
    else:
        mix = (f"{cfg.num_heads} heads, mLSTM/sLSTM d_inner "
               f"{cfg.ssm_expand * cfg.d_model}, tied embeddings")
    n = sum(p.numel() for p in model.parameters())
    cut = ("none, full depth" if cfg.num_layers == full.num_layers
           else f"depth {full.num_layers} -> {cfg.num_layers} layers")
    print(f"[ssm] {arch}: published widths (d_model {cfg.d_model}, {mix}, "
          f"vocab {cfg.vocab_size}, ssm chunk {cfg.ssm_chunk}, {cfg.dtype});"
          f" cut: {cut} ({kinds}); {n / 1e9:.4f} G parameters, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, model


def ssm_alone_check(cfg, model, seed: int, batched, over) -> dict:
    """C3 on the card: the three shortest requests of the run ``batched``
    (label), with the config overrides ``over``, each served alone on a
    fresh server of the same batch size and options, then the three
    batched on one server fed the alone-served tokens (teacher forcing);
    the batched tokens must pass the gate against the alone-served
    ones."""
    arch, kw, impl, _ = SSM_RUNS[batched]
    cfg = dataclasses.replace(cfg, **over)
    three = lambda: ssm_shortest(arch, seed, 3)     # noqa: E731
    alone = []
    for r in three():
        (done,), _, _ = serve_once(cfg, model, attn_impl=impl, seed=seed,
                                   trace=lambda c, sd, r=r: [r],
                                   **SSM_SERVE[arch], **kw)
        alone.append(done.out)
    reqs, _, _ = serve_once(cfg, model, attn_impl=impl, seed=seed,
                            trace=lambda c, sd: three(),
                            forced={r.rid: out for r, out in
                                    zip(three(), alone)},
                            **SSM_SERVE[arch], **kw)
    g = accuracy_gate(alone, [r.out for r in reqs])
    moe = f", MoE {cfg.moe_mode}" if cfg.num_experts else ""
    print(f"[ssm] {arch} ({batched}{moe}) alone vs batched: the three "
          f"shortest requests served one by one on fresh servers, then "
          f"batched fed their tokens: agreement {g['agreement']:.4f} "
          f"({g['below_floor']} "
          f"below 0.5) -> {'pass' if g['passed'] else 'FAIL'}", flush=True)
    if not g["passed"]:
        raise AssertionError(f"[ssm] {arch}: batched tokens fail the gate "
                             f"against the alone-served ones: {g}")
    return g


def ssm_arch_runs(arch, seed: int, runs: dict, caps: dict,
                  alone: dict) -> int:
    """The [ssm] runs of ``arch`` on one model (see :func:`ssm_phase`),
    recorded in ``runs`` (label -> (requests, stats, tap)), ``caps``
    (label -> B1 against plain on captured pools) and ``alone`` (the
    alone-vs-batched gate). Returns the B1 launches. The model, servers
    and taps die with the call."""
    import torch
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.models import attention

    cfg, model = ssm_model(arch, seed)
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    n_attn = sum(blk.sig[0] == "attn" for blk in model.layers)
    labels = [lb for lb, r in SSM_RUNS.items() if r[0] == arch]
    # one short untimed run first, so that no timed run pays the card's
    # one-time costs
    t0 = time.perf_counter()
    warm = ssm_shortest(arch, seed, 2)
    for r in warm:
        r.max_new = 2
    first = SSM_RUNS[labels[0]]
    serve_once(cfg, model, attn_impl=first[2], seed=seed,
               trace=lambda c, sd: warm, **SSM_SERVE[arch], **first[1])
    print(f"[ssm] {arch}: untimed warm-up run (the 2 shortest requests, 2 "
          f"new tokens, as ({labels[0]})) {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches, taps = 0, {}
    for label in labels:
        _, kw, impl, by = SSM_RUNS[label]
        cap = None
        if impl == "kernel":
            cap = B1Capture(attention.paged_kv_attention_decode, at=100,
                            layers=n_attn)
            attention.paged_kv_attention_decode = cap
        forced = {r.rid: r.out for r in runs[by][0]} if by else None
        keep = {}
        paged_kv_attention_chunk.launches = 0
        try:
            reqs, st, taps[label] = serve_once(
                cfg, model, attn_impl=impl, seed=seed,
                trace=lambda c, sd: ssm_trace(arch, sd), forced=forced,
                tap=True, keep=keep, **SSM_SERVE[arch], **kw)
        finally:
            if cap is not None:
                attention.paged_kv_attention_decode = cap.fn
        n = paged_kv_attention_chunk.launches
        if impl == "kernel" and n != n_attn * st["program_launches"]:
            raise AssertionError(f"[ssm] ({label}): B1 launches {n} != "
                                 f"attention layers x programs "
                                 f"{n_attn} x {st['program_launches']}")
        if impl == "gather" and n:
            raise AssertionError(f"[ssm] ({label}): the gather route "
                                 f"launched B1 {n} times")
        launches += n
        st.update(label=label, arch=arch, b1_launches=n,
                  weights_gib=weights_gib,
                  counters=moe_counters(keep["srv"]))
        if by:
            st.update(compare_logits(taps[by], taps[label]))
        if cap is not None:
            caps[label] = check_captured_b1(
                cap.saved, f"({label}) kv_bits={kw['kv_bits']} G="
                f"{cfg.num_heads // cfg.num_kv_heads}", tag="[ssm]")
        runs[label] = (reqs, st, None)
        print(f"[ssm] ({label}) {arch} kv_bits={kw['kv_bits']} {impl}"
              f"{f' forced by ({by})' if by else ''}: "
              f"{st['tok_per_s']:.1f} tok/s, decode step "
              f"{st['decode_step_ms']:.2f} ms x {st['decode_steps']} "
              f"(and the stepwise prefill's programs), B1 x {n}, peak "
              f"{st['max_memory_allocated_gib']:.2f} GiB (weights "
              f"{weights_gib:.2f}); {st['counters']}"
              + (f"; logits vs ({by}) on identical inputs differ by at "
                 f"most {st['max_abs_logit_diff']:.4g} (median "
                 f"{st['median_max_abs_logit_diff']:.4g}, "
                 f"{st['top2_tied_steps']} steps with the top two tied)"
                 if by else ""), flush=True)
    alone[arch] = ssm_alone_check(cfg, model, seed, *SSM_ALONE[arch])
    label, over = SSM_MESH[arch]
    _, kw, impl, by = SSM_RUNS[label]
    n, caps[f"{label} mesh"] = mesh_arm(
        "[ssm]", f"({label})", cfg, model, seed=seed, impl=impl,
        forced={r.rid: r.out for r in runs[by][0]} if by else None,
        trace=lambda c, sd: ssm_trace(arch, sd)[:SSM_MESH_REQUESTS],
        **dict(SSM_SERVE[arch], **over), **kw)
    launches += n
    if arch == JAMBA:
        launches += ssm_preempt_check(cfg, model, seed, runs)
    return launches


def ssm_preempt_check(cfg, model, seed: int, runs: dict) -> int:
    """Run (f), C4 on the card: jamba at exact routing (eval_all) on int8
    pages through B1, SLO scheduling with the host tier and preemption
    (``SSM_PREEMPT_*``), teacher-forced by the same requests served
    uninterrupted (batch size 1, no SLO scheduling, the same route); it
    must preempt at least twice and pass the gate. Records (f) in
    ``runs``; returns the B1 launches of both runs."""
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk

    cfg = dataclasses.replace(cfg, moe_mode="eval_all")
    n_attn = sum(blk.sig[0] == "attn" for blk in model.layers)
    launches, taps, out = 0, {}, {}
    for label, pool, by in (("f0", {}, None), ("f", SSM_PREEMPT_POOL, "f0")):
        keep = {}
        paged_kv_attention_chunk.launches = 0
        out[label], st, taps[label] = serve_once(
            cfg, model, attn_impl="kernel", seed=seed,
            trace=lambda c, sd: ssm_preempt_trace(sd),
            forced=({r.rid: r.out for r in out[by]} if by else None),
            tap=True, keep=keep, **SSM_PREEMPT_SERVE, **pool)
        n = paged_kv_attention_chunk.launches
        if n != n_attn * st["program_launches"]:
            raise AssertionError(f"[ssm] ({label}): B1 launches {n} != "
                                 f"{n_attn} x {st['program_launches']}")
        launches += n
        srv = keep["srv"]
        st.update(label=label, arch=JAMBA, b1_launches=n,
                  counters=preempt_counters(srv, out[label]) if pool else
                  moe_counters(srv))
        print(f"[ssm] ({label}) {JAMBA} eval_all kv_bits=8 kernel, "
              + (f"SLO + host tier + preemption forced by ({by})"
                 if pool else "uninterrupted")
              + f": {st['tok_per_s']:.1f} tok/s, decode step "
              f"{st['decode_step_ms']:.2f} ms x {st['decode_steps']}, B1 x "
              f"{n}; {st['counters']}", flush=True)
        if label == "f":
            if srv.preempt_count < 2:
                raise AssertionError(f"[ssm] (f) preempted "
                                     f"{srv.preempt_count} times, not 2")
            st.update(compare_logits(taps[by], taps[label]))
            g = accuracy_gate([r.out for r in out[by]],
                              [r.out for r in out[label]])
            st["gate"] = g
            print(f"[ssm] (f) vs (f0), teacher-forced: {srv.preempt_count} "
                  f"preemptions and {srv.resume_count} resumes on parked "
                  f"state rows; agreement {g['agreement']:.4f} "
                  f"({g['below_floor']} below 0.5) -> "
                  f"{'pass' if g['passed'] else 'FAIL'}", flush=True)
            if not g["passed"]:
                raise AssertionError(f"[ssm] (f) fails the gate against "
                                     f"the uninterrupted run: {g}")
            runs[label] = (out[label], st, None)
    return launches


def ssm_phase(seed: int):
    """``[ssm]``: xlstm-350m cut to 8 of its 24 layers (one period: 7
    mLSTM blocks and 1 sLSTM block) on dense recurrent states, batch 4,
    8 requests of 16-48 prompt tokens and 16 new, stepwise prefill (the
    server's rule for archs that are not attention-only): (a) bf16
    states, (b) kv_bits 8, which puts the mLSTM memories on the Q2.6
    grid each chunk, teacher-forced by (a);
    then jamba-v0.1-52b cut to one 8-layer period (7 Mamba layers, the
    attention layer 4 at G = 4, MoE of 16 experts top-2 scatter on the
    odd layers) on paged pools, page size 16: (c) int8 gather, (d) int8
    kernel teacher-forced by (c), (e) int4 kernel fed (c)'s tokens. One
    model on the card at a time, each after an untimed warm-up. Fails
    unless every request finishes, B1 runs once per attention layer per
    program on the kernel runs, (d) passes the gate against (c), B1 equals
    its plain version on the pools of one captured decode step of (d) and
    (e), three requests served alone equal (by the gate) their batched
    tokens, (f) (:func:`ssm_preempt_check`: C4 on the card) preempts at
    least twice and passes the gate against the same requests served
    uninterrupted, every run's host counters equal the smoke configs'
    on the CPU for the same trace (a child process), and the mesh arms
    (``SSM_MESH``, :func:`mesh_arm`) are their plain servers bit for bit.
    Returns (B1 launches, run records)."""
    import concurrent.futures
    import gc
    import multiprocessing

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    print(f"[ssm] card memory held before the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    src = str(Path(__file__).resolve().parent / "src")
    rehearsal = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    runs, caps, alone, launches = {}, {}, {}, 0
    try:
        cpu_future = rehearsal.submit(cpu_ssm_counters, seed, src)
        for arch in (XLSTM, JAMBA):
            launches += ssm_arch_runs(arch, seed, runs, caps, alone)
            gc.collect()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated() / 2 ** 30
            print(f"[ssm] {arch} freed: {held:.2f} GiB still allocated",
                  flush=True)
            if held > 1.0:
                raise AssertionError(f"[ssm] {arch}'s model stayed on the "
                                     f"card ({held:.2f} GiB)")
        t_card = time.perf_counter() - t_phase
        cpu = cpu_future.result()
    finally:
        rehearsal.shutdown(wait=True, cancel_futures=True)
    gates = {}
    for label, ref in {**SSM_GATED, **SSM_OBSERVED}.items():
        g = accuracy_gate([r.out for r in runs[ref][0]],
                          [r.out for r in runs[label][0]])
        gated = label in SSM_GATED
        print(f"[ssm] ({label}) vs ({ref}), teacher-forced"
              f"{'' if gated else ' (observed, no limit)'}: agreement "
              f"{g['agreement']:.4f} ({g['below_floor']} below 0.5)"
              + (f" -> {'pass' if g['passed'] else 'FAIL'}" if gated
                 else ""), flush=True)
        if gated and not g["passed"]:
            raise AssertionError(f"[ssm] ({label}) fails the gate: {g}")
        gates[label] = g["agreement"]
    for label, (_, st, _) in runs.items():
        if st["counters"] != cpu[label]:
            raise AssertionError(f"[ssm] ({label}): counters "
                                 f"{st['counters']} != CPU {cpu[label]}")
    print(f"[ssm] host counters equal the smoke configs' on the CPU for "
          f"the same token traces, runs (a)-(f)", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"[ssm] main path: {launches} B1 launches = attention layers x "
          f"programs over the kernel runs; phase {wall:.1f} s against a "
          f"{SSM_BUDGET_S} s budget (card runs and model init "
          f"{t_card:.1f} s, the CPU rehearsal beside them)", flush=True)
    out = [dict(st, phase="ssm") for _, st, _ in runs.values()]
    out.append({"phase": "ssm", "gates": gates, "cpu_counters": cpu,
                "captured_b1": caps, "alone": alone, "phase_s": wall,
                "budget_s": SSM_BUDGET_S})
    return launches, out


# ---------------------------------------------------------------------------
# [frontend]: the encoder and VLM families at published widths and depth:
# hubert-xlarge's bidirectional forward on stub frame embeddings, and
# qwen2-vl-2b served from tokens through B1 at G = 6 and decoded from stub
# patch embeddings with M-RoPE
# ---------------------------------------------------------------------------
HUBERT, QWENVL = "hubert-xlarge", "qwen2-vl-2b"
ENC_SHAPES = ((4, 1024), (2, 2048))   # (B, S): attend_full; chunked
ENC_REPS = 3                          # timed forwards a shape
VLM_TRAFFIC = dict(n=8, lo=16, hi=48, max_new=16)
VLM_SERVE = dict(batch_size=4, max_len=96, page_size=PS)
VLM_RUNS = {
    # label: (server options, route, forced by)
    "b1": (dict(kv_bits=8), "gather", None),
    "b2": (dict(kv_bits=8), "kernel", "b1"),
    "b3": (dict(kv_bits=4), "kernel", "b1"),
}
VLM_GATED = {"b2": "b1"}              # teacher-forced gate
VLM_OBSERVED = {"b3": "b1"}           # teacher-forced, no limit
VLM_GRID, VLM_TEXT, VLM_DECODE = (1, 16, 16), 32, 8   # (c)
VLM_MESH, VLM_MESH_REQUESTS = "b2", 2      # (b2)'s prefix on a mesh
DECODE_RTOL, DECODE_ATOL = 0.12, 0.08  # tests/test_models.py's bound
BF16_FLOP_PER_S = 989e12               # H100 SXM dense bf16 (data sheet)
FRONTEND_BUDGET_S = 45


def vlm_trace(seed: int, vocab=None):
    """(b)'s 8 requests in qwen2-vl-2b's published vocabulary, or mapped
    into ``vocab`` position by position (:func:`map_vocab`)."""
    from repro_torch.configs.registry import get_config
    reqs = served_requests(get_config(QWENVL), seed + 9, **VLM_TRAFFIC)
    return reqs if vocab is None else map_vocab(reqs, vocab)


def cpu_frontend_counters(seed: int, src: str) -> dict:
    """Every (b) run's server on the CPU with qwen2-vl-2b's smoke config,
    the trace mapped into its vocabulary, through the gather route (the
    counters depend on prompts and pages only). Runs in a child process
    beside the card runs, on one thread."""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config(QWENVL)
    model = init_model(cfg, seed=seed, device="cpu")
    out, seen = {}, {}
    for label, (kw, _, _) in VLM_RUNS.items():
        key = tuple(sorted(kw.items()))
        if key not in seen:
            srv = BatchedServer(cfg, model, attn_impl="gather",
                                prefill_bucket=32, device="cpu",
                                **VLM_SERVE, **kw)
            srv.run(vlm_trace(seed, cfg.vocab_size))
            seen[key] = moe_counters(srv)
        out[label] = seen[key]
    return out


def frontend_model(arch, seed: int):
    """The arch at published widths and depth, bf16, random weights from
    a seeded generator; prints its shape."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import init_model
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    print(f"[frontend] {arch}: published widths and depth ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim} (G = "
          f"{cfg.num_heads // cfg.num_kv_heads}), d_ff {cfg.d_ff} "
          f"{'GELU' if cfg.family == 'encoder' else 'SwiGLU'}, vocab "
          f"{cfg.vocab_size}, {'bidirectional' if not cfg.causal else 'causal'}"
          f"{', M-RoPE, QKV bias, tied' if cfg.mrope else ''}, {cfg.dtype}); "
          f"{n / 1e9:.4f} G parameters, "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, model


def encoder_runs(seed: int) -> dict:
    """(a): hubert-xlarge's whole forward (``make_prefill_step``'s encoder
    branch: every frame's logits, no cache) on stub frame embeddings from
    ``make_batch``, at B = 4, S = 1024 (``attend_full``) and B = 2, S =
    2048 (the non-causal ``attend_chunked``): ms a forward (CUDA events,
    median of ``ENC_REPS`` after one untimed), frames/s, peak memory and
    the bound (the larger of 2 N frames + 4 S^2 d_model layers B FLOPs
    at the bf16 peak and the weights' bytes at the memory rate; N counts
    the parameters a frame uses, the token table left out). Fails unless
    the logits are finite and of shape (B, S, V), and changing the last
    frame's embedding changes frame 0's logits in every row. Last, one
    forward under weights Q2.6 / data Q4.12: its top-1 unit agreement
    with the float forward (observed, no limit)."""
    import torch
    from repro_torch.configs.shapes import ShapeConfig, make_batch
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.quant.apply import (build_model_quant,
                                         transformer_layer_names)

    cfg, model = frontend_model(HUBERT, seed)
    n_all = sum(p.numel() for p in model.parameters())
    n_used = n_all - model.embed.numel()
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    out, first = {}, None

    def timed(step, emb):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        logits, caches = step(model, embeds=emb)
        b.record()
        torch.cuda.synchronize()
        return logits, caches, a.elapsed_time(b)

    for B, S in ENC_SHAPES:
        g = torch.Generator(device="cuda")
        g.manual_seed(seed + S)
        emb = make_batch(cfg, ShapeConfig(f"frames_{S}", S, B, "prefill"),
                         generator=g, device="cuda")["embeds"]
        step = make_prefill_step(cfg, max_len=S)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logits, caches, _ = timed(step, emb)          # untimed first call
        ms = float(np.median([timed(step, emb)[2]
                              for _ in range(ENC_REPS)]))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if caches is not None or logits.shape != (B, S, cfg.vocab_size) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"[frontend] (a) S={S}: bad logits "
                                 f"{tuple(logits.shape)}")
        flops = 2 * n_used * B * S + 4 * S * S * cfg.d_model \
            * cfg.num_layers * B
        bound = max(flops / BF16_FLOP_PER_S, w_bytes / HBM_BYTES_PER_S) * 1e3
        path = ("attend_full" if S * S <= cfg.attn_chunk ** 2
                else f"attend_chunked (chunk {cfg.attn_chunk}, non-causal)")
        rec = {"B": B, "S": S, "path": path, "forward_ms": ms,
               "frames_per_s": B * S / ms * 1e3, "peak_gib": peak,
               "flops": flops, "bound_ms": bound,
               "bound_by": "operations" if flops / BF16_FLOP_PER_S
               >= w_bytes / HBM_BYTES_PER_S else "bytes"}
        out[f"S{S}"] = rec
        print(f"[frontend] (a) hubert-xlarge B = {B}, S = {S} ({path}): "
              f"{ms:.2f} ms a forward (median of {ENC_REPS}), "
              f"{rec['frames_per_s']:.0f} frames/s, peak {peak:.2f} GiB; "
              f"bound {bound:.2f} ms ({flops / 1e12:.2f} TFLOP at the bf16 "
              f"peak; {rec['bound_by']}), {bound / ms:.2%} of it", flush=True)
        rec["profile"] = profiled(lambda: step(model, embeds=emb), 1,
                                  "[frontend]", f"(a) B = {B}, S = {S}")
        if first is None:
            first = (step, emb, logits)
    step, emb, logits = first
    moved = emb.clone()
    moved[:, -1] += 1.0
    with torch.no_grad():
        other = step(model, embeds=moved)[0]
    delta = (other[:, 0] - logits[:, 0]).abs().amax(dim=-1)
    print(f"[frontend] (a) non-causality: the last frame's embedding moved "
          f"by 1.0 moves frame 0's logits by at most "
          f"{[round(float(d), 4) for d in delta]} per row", flush=True)
    if not bool((delta > 0).all()):
        raise AssertionError("[frontend] (a) frame 0 did not see the last "
                             "frame: the encoder attends causally")
    names = transformer_layer_names(cfg)
    quant = build_model_quant(
        PrecisionPolicy.uniform(names, FixedPointFormat(2, 6),
                                FixedPointFormat(4, 12)),
        cfg, quantize_kv=False)
    qlogits, _, qms = timed(make_prefill_step(cfg, max_len=emb.shape[1],
                                              quant=quant), emb)
    if not bool(torch.isfinite(qlogits).all()):
        raise AssertionError("[frontend] (a) quantized logits not finite")
    agree = float((qlogits.argmax(-1) == logits.argmax(-1)).float().mean())
    out["quant"] = {"forward_ms": qms, "top1_agreement": agree}
    print(f"[frontend] (a) weights Q2.6 / data Q4.12 (the [quant] policy): "
          f"forward {qms:.2f} ms, top-1 unit agreement with the float "
          f"forward {agree:.4f} over {logits.shape[0] * logits.shape[1]} "
          f"frames (observed, no limit)", flush=True)
    out["parameters"] = n_all
    return out


def vlm_serve_runs(cfg, model, seed: int, runs: dict, caps: dict) -> int:
    """(b): qwen2-vl-2b served from token ids by ``BatchedServer`` (plain
    RoPE, as the reference serves it), recorded in ``runs`` and ``caps``
    (B1 against plain on captured pools); returns the B1 launches."""
    import torch
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.models import attention

    L = cfg.num_layers
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    warm = sorted(vlm_trace(seed), key=lambda r: len(r.prompt))[:2]
    for r in warm:
        r.max_new = 2
    kw, impl, _ = VLM_RUNS["b1"]
    serve_once(cfg, model, attn_impl=impl, seed=seed,
               trace=lambda c, sd: warm, **VLM_SERVE, **kw)
    print(f"[frontend] (b) untimed warm-up run (the 2 shortest requests, 2 "
          f"new tokens, as (b1)) {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches, taps = 0, {}
    for label, (kw, impl, by) in VLM_RUNS.items():
        cap = chunk_cap = None
        if impl == "kernel":
            cap = B1Capture(attention.paged_kv_attention_decode, at=6 * L,
                            layers=L)
            attention.paged_kv_attention_decode = cap
            chunk_cap = B1ChunkCapture(attention.paged_kv_attention_chunk,
                                       layers=L, S=32, past_start=False)
            attention.paged_kv_attention_chunk = chunk_cap
        forced = {r.rid: r.out for r in runs[by][0]} if by else None
        keep = {}
        paged_kv_attention_chunk.launches = 0
        try:
            reqs, st, taps[label] = serve_once(
                cfg, model, attn_impl=impl, seed=seed,
                trace=lambda c, sd: vlm_trace(sd), forced=forced, tap=True,
                keep=keep, **VLM_SERVE, **kw)
        finally:
            if cap is not None:
                attention.paged_kv_attention_decode = cap.fn
                attention.paged_kv_attention_chunk = chunk_cap.fn
        n = paged_kv_attention_chunk.launches
        if impl == "kernel" and n != L * st["program_launches"]:
            raise AssertionError(f"[frontend] ({label}): B1 launches {n} "
                                 f"!= layers x programs "
                                 f"{L} x {st['program_launches']}")
        if impl == "gather" and n:
            raise AssertionError(f"[frontend] ({label}): the gather route "
                                 f"launched B1 {n} times")
        launches += n
        st.update(label=label, arch=QWENVL, b1_launches=n,
                  weights_gib=weights_gib,
                  counters=moe_counters(keep["srv"]))
        if by:
            st.update(compare_logits(taps[by], taps[label]))
        if cap is not None:
            what = (f"({label}) kv_bits={kw['kv_bits']} G="
                    f"{cfg.num_heads // cfg.num_kv_heads}")
            caps[label] = {
                "decode": check_captured_b1(cap.saved, what,
                                            tag="[frontend]"),
                "prefill": check_captured_b1_chunk(chunk_cap.saved, what,
                                                   tag="[frontend]")}
        runs[label] = (reqs, st, None)
        print(f"[frontend] ({label}) {QWENVL} kv_bits={kw['kv_bits']} "
              f"{impl}{f' forced by ({by})' if by else ''}: "
              f"{st['tok_per_s']:.1f} tok/s, decode step "
              f"{st['decode_step_ms']:.2f} ms x {st['decode_steps']}, "
              f"prefill forward {st['prefill_forward_ms']:.2f} ms, B1 x {n}, "
              f"peak {st['max_memory_allocated_gib']:.2f} GiB (weights "
              f"{weights_gib:.2f}); {st['counters']}"
              + (f"; logits vs ({by}) on identical inputs differ by at "
                 f"most {st['max_abs_logit_diff']:.4g} (median "
                 f"{st['median_max_abs_logit_diff']:.4g})" if by else ""),
              flush=True)
    kw, impl, by = VLM_RUNS[VLM_MESH]
    n, caps[f"{VLM_MESH} mesh"] = mesh_arm(
        "[frontend]", f"({VLM_MESH})", cfg, model, seed=seed, impl=impl,
        forced={r.rid: r.out for r in runs[by][0]} if by else None,
        trace=lambda c, sd: vlm_trace(sd)[:VLM_MESH_REQUESTS],
        **VLM_SERVE, **kw)
    return launches + n


def vlm_embeds_check(cfg, model, seed: int, *, gated: bool) -> dict:
    """(c): qwen2-vl-2b's embeds path on dense caches in the model's
    dtype: ``prefill`` of 2 rows of stub patch embeddings with M-RoPE ids
    (a 16 x 16 grid at t = 0, then 32 text positions whose three ids are
    equal, continuing after the grid's largest id; ``make_batch``), then
    ``VLM_DECODE`` ``make_embed_decode_step`` steps, each fed the
    embedding of the last token chosen (plain RoPE at the cache
    position). Each step's logits, and the prefill's last, are held
    against one forward over the whole extended sequence (the decoded
    positions' three ids equal to their cache positions) at the
    reference's decode-consistency bound (rtol 0.12, atol 0.08, set for
    its float32 test): ``gated`` fails the run outside it, else (the
    bf16 run, whose decode steps are profiled) the excess is printed as
    observed. Prints the argmax agreement."""
    import torch
    from repro_torch.configs.shapes import ShapeConfig, make_batch, mrope_ids
    from repro_torch.launch.steps import make_embed_decode_step
    from repro_torch.models.transformer import forward, prefill

    S = VLM_GRID[0] * VLM_GRID[1] * VLM_GRID[2] + VLM_TEXT
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 11)
    batch = make_batch(cfg, ShapeConfig("patches", S, 2, "prefill"),
                       generator=g, device="cuda")
    emb, ids = batch["embeds"], batch["mrope_positions"]
    if ids[1].tolist() != mrope_ids(VLM_GRID, VLM_TEXT).tolist():
        raise AssertionError("[frontend] (c) the batch's ids are not a "
                             "16 x 16 grid then text")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last, caches, pos = prefill(model, None, cfg, max_len=S + VLM_DECODE,
                                embeds=emb, mrope_positions=ids)
    dec = StepTimer(make_embed_decode_step(cfg))
    st = {"nxt": last.argmax(-1), "caches": caches}
    feeds, logits = [], [last]

    def one():
        feeds.append(model.embed[st["nxt"].long()][:, None])
        st["nxt"], lg, st["caches"] = dec(model, feeds[-1],
                                          pos + len(feeds) - 1, st["caches"])
        logits.append(lg)
    prof = None if gated else profiled(
        one, 2, "[frontend]", f"(c) {cfg.dtype} embed-decode steps, batch 2")
    while len(feeds) < VLM_DECODE:
        one()
    ext = torch.arange(pos, pos + VLM_DECODE, device="cuda", dtype=ids.dtype)
    ext_ids = torch.cat([ids, ext[None, :, None].expand(2, -1, 3)], dim=1)
    with torch.no_grad():
        full = forward(model, None, cfg, embeds=torch.cat([emb] + feeds, 1),
                       mrope_positions=ext_ids)[1]
    torch.cuda.synchronize()
    worst, agree = -np.inf, 0
    for i, lg in enumerate(logits):
        ref = full[:, pos - 1 + i].float()
        excess = ((lg.float() - ref).abs()
                  - (DECODE_ATOL + DECODE_RTOL * ref.abs())).amax()
        worst = max(worst, float(excess))
        agree += int((lg.argmax(-1) == ref.argmax(-1)).sum())
    n = 2 * len(logits)
    res = {"dtype": cfg.dtype, "prompt_positions": S,
           "decode_steps": VLM_DECODE, "decode_step_ms": dec.ms(),
           "argmax_agreement": agree / n, "worst_excess_over_tol": worst,
           "within": worst <= 0, "gated": gated, "profile": prof,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    print(f"[frontend] (c) {QWENVL} embeds path, {cfg.dtype}: prefill of "
          f"2 x {S} stub patch embeddings (M-RoPE: a {VLM_GRID[1]} x "
          f"{VLM_GRID[2]} grid, then {VLM_TEXT} text ids) and {VLM_DECODE} "
          f"embed-decode steps ({res['decode_step_ms']:.2f} ms each) on "
          f"dense {cfg.dtype} caches, each against a forward over the "
          f"extended sequence at rtol {DECODE_RTOL}, atol {DECODE_ATOL}: "
          f"largest |difference| less its allowance {worst:.4g} -> "
          + ("within" if res["within"] else "outside")
          + ("" if gated else " (observed, no limit)")
          + f"; argmax agreement {res['argmax_agreement']:.4f}; peak "
          f"{res['peak_gib']:.2f} GiB", flush=True)
    if not bool(torch.isfinite(full).all()) or (gated
                                                and not res["within"]):
        raise AssertionError(f"[frontend] (c) decode logits leave the "
                             f"reference's bound: {res}")
    return res


def frontend_phase(seed: int):
    """``[frontend]``: (a) hubert-xlarge at its published widths and depth
    (48 layers) on stub frame embeddings (:func:`encoder_runs`); then,
    that model freed, qwen2-vl-2b at its published widths and depth (28
    layers, B1 at G = 12 / 2 = 6): (b) 8 requests of 16-48 prompt tokens
    and 16 new at batch 4, page size 16, bucketed prefill, after an
    untimed warm-up: (b1) int8 gather, (b2) int8 kernel teacher-forced by
    (b1), (b3) int4 kernel fed (b1)'s tokens; (c) the embeds path
    (:func:`vlm_embeds_check`). Fails unless every request finishes, B1
    runs once per layer per program on the kernel runs, (b2) passes the
    gate against (b1), B1 equals its plain version on the pools of one
    captured decode step and one bucketed S = 32 prefill forward of (b2)
    and (b3) at G = 6, every (b) run's host counters equal qwen2-vl-2b-
    smoke's on the CPU for the same trace (a child process), (a) passes
    its checks and (c) holds the reference's decode bound on the model
    cast to float32 ((c) in bf16 is printed as observed), and (b2)'s
    first requests on a one-rank NCCL mesh (:func:`mesh_arm`) are its
    plain server's bit for bit. Returns (B1 launches, run records)."""
    import concurrent.futures
    import gc
    import multiprocessing

    import torch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    held = torch.cuda.memory_allocated() / 2 ** 30
    print(f"[frontend] card memory held before the phase: {held:.2f} GiB",
          flush=True)
    src = str(Path(__file__).resolve().parent / "src")
    rehearsal = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    runs, caps, part_s = {}, {}, {}
    try:
        cpu_future = rehearsal.submit(cpu_frontend_counters, seed, src)
        enc = encoder_runs(seed)
        gc.collect()
        torch.cuda.empty_cache()
        part_s["a"] = time.perf_counter() - t_phase
        cfg, model = frontend_model(QWENVL, seed)
        launches = vlm_serve_runs(cfg, model, seed, runs, caps)
        part_s["b"] = time.perf_counter() - t_phase - part_s["a"]
        embeds = {"bf16": vlm_embeds_check(cfg, model, seed, gated=False)}
        # the reference's bound is set for float32: the same check on
        # the model cast to float32 (TF32 off) is the gate
        embeds["float32"] = vlm_embeds_check(
            dataclasses.replace(cfg, dtype="float32"), model.float(), seed,
            gated=True)
        part_s["c"] = (time.perf_counter() - t_phase - part_s["a"]
                       - part_s["b"])
        del model
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() / 2 ** 30
        print(f"[frontend] models freed: {held:.2f} GiB still allocated",
              flush=True)
        if held > 1.0:
            raise AssertionError(f"[frontend] a model stayed on the card "
                                 f"({held:.2f} GiB)")
        t_card = time.perf_counter() - t_phase
        cpu = cpu_future.result()
    finally:
        rehearsal.shutdown(wait=True, cancel_futures=True)
    gates = {}
    for label, ref in {**VLM_GATED, **VLM_OBSERVED}.items():
        g = accuracy_gate([r.out for r in runs[ref][0]],
                          [r.out for r in runs[label][0]])
        gated = label in VLM_GATED
        print(f"[frontend] ({label}) vs ({ref}), teacher-forced"
              f"{'' if gated else ' (observed, no limit)'}: agreement "
              f"{g['agreement']:.4f} ({g['below_floor']} below 0.5)"
              + (f" -> {'pass' if g['passed'] else 'FAIL'}" if gated
                 else ""), flush=True)
        if gated and not g["passed"]:
            raise AssertionError(f"[frontend] ({label}) fails the gate: {g}")
        gates[label] = g["agreement"]
    for label, (_, st, _) in runs.items():
        if st["counters"] != cpu[label]:
            raise AssertionError(f"[frontend] ({label}): counters "
                                 f"{st['counters']} != CPU {cpu[label]}")
    print(f"[frontend] host counters equal qwen2-vl-2b-smoke's on the CPU "
          f"for the same token trace, runs (b1)-(b3)", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"[frontend] main path: {launches} B1 launches = layers x "
          f"programs over the kernel runs; phase {wall:.1f} s against a "
          f"{FRONTEND_BUDGET_S} s budget (card runs and model init "
          f"{t_card:.1f} s: (a) {part_s['a']:.1f}, (b) {part_s['b']:.1f}, "
          f"(c) {part_s['c']:.1f}; the CPU rehearsal beside them)",
          flush=True)
    out = [dict(st, phase="frontend") for _, st, _ in runs.values()]
    out.append({"phase": "frontend", "encoder": enc, "embeds": embeds,
                "gates": gates, "cpu_counters": cpu, "captured_b1": caps,
                "phase_s": wall, "part_s": part_s,
                "budget_s": FRONTEND_BUDGET_S})
    return launches, out


# ---------------------------------------------------------------------------
# [bench]: the port's serving benches with qwen2-72b at published widths
# ---------------------------------------------------------------------------
# qwen2-72b's 80 layers cut to 6: at [serve]'s 8 the phase ran 61.5 s
# in a full run, over its budget
BENCH_LAYERS = 6
BENCH_BUDGET_S = 60
BENCH_WORKLOADS = ("mixed", "prefix", "overcommit", "adapt", "ragged")
# the kernel row's B1 inputs held against plain: its 37th served decode
# step (the warm-up serves 5; this one's 4 rows hold 36-43 keys over 3
# pages each of the 13-page pool) and its second 16-query prefill forward
# (the first is the warm-up's, one row)
BENCH_DECODE_AT, BENCH_PREFILL_S, BENCH_PREFILL_SKIP = 36, 16, 1


def bench_workloads(cfg, model, *, vocab: int, teacher_force: bool,
                    verbose: bool):
    """Every workload of ``benchmarks.paged_serve`` (mixed with batched
    prefill, prefix, overcommit, adapt, ragged) and
    ``benchmarks.traffic.run_serve`` on ``model``, their traces drawn
    from ``vocab``. Returns (results by workload, seconds by workload)."""
    from repro_torch.benchmarks import paged_serve, traffic
    out, secs = {}, {}
    kw = dict(vocab=vocab, teacher_force=teacher_force, verbose=verbose)
    for w in BENCH_WORKLOADS:
        t0 = time.perf_counter()
        out[w] = paged_serve.run(cfg, model, workload=w, **kw)
        secs[w] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["traffic"] = traffic.run_serve(cfg, model, **kw)
    secs["traffic"] = time.perf_counter() - t0
    return out, secs


def bench_counters(res: dict) -> dict:
    """Each workload's host counters (``paged_serve.host_counters``, read
    by name); the traffic harness's predictor-on arm is left out, since
    its admissions follow the wall clock (ROADMAP queue C, C2)."""
    from repro_torch.benchmarks.paged_serve import host_counters
    return {w: host_counters(w.split("@")[0], r, wall_clock=False)
            for w, r in res.items()}


def cpu_bench_counters(seed: int, src: str) -> dict:
    """The same benches on qwen2-72b's smoke config on the CPU (the traces
    are drawn from its vocabulary, as the card's), teacher-forced as the
    card's (a random-init model's free-running tokens flip on ties here
    too), results in a scratch directory. The adapt workload runs again
    on the smoke config at qwen2-72b's KV geometry (8 KV heads of 128,
    one layer): its quant tier's budget is bytes, and the per-page scales'
    share of a page's bytes, larger at the smoke config's 2 KV heads of
    8, moves its deepen count; that run is the one held against the
    card's, the smoke config's is returned as ``"adapt@smoke"``. Runs in
    a child process beside the card runs, on one thread."""
    import tempfile
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch.benchmarks import common, paged_serve
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config("qwen2-72b")
    model = init_model(cfg, seed=seed, device="cpu")
    full = get_config("qwen2-72b")
    geo = dataclasses.replace(cfg, num_layers=1, num_heads=full.num_kv_heads,
                              num_kv_heads=full.num_kv_heads,
                              head_dim=full.head_dim)
    with tempfile.TemporaryDirectory() as tmp, common.results_in(tmp):
        out, _ = bench_workloads(cfg, model, vocab=cfg.vocab_size,
                                 teacher_force=True, verbose=False)
        out["adapt@smoke"] = out["adapt"]
        out["adapt"] = paged_serve.run_adapt(
            geo, init_model(geo, seed=seed, device="cpu"), verbose=False,
            teacher_force=True, vocab=cfg.vocab_size)
    return bench_counters(out)


def _agreements(res, prefix=""):
    """Every ``*agreement*`` number of a result, by dotted key."""
    out = {}
    for k, v in res.items():
        if isinstance(v, dict):
            out.update(_agreements(v, f"{prefix}{k}."))
        elif "agreement" in k and isinstance(v, (int, float)):
            out[prefix + k] = v
    return out


def bench_phase(seed: int):
    """``[bench]``: the port's serving benches (:func:`bench_workloads`)
    with qwen2-72b at its published widths cut to ``BENCH_LAYERS`` layers
    (bf16, random weights from a seeded generator), the traces drawn from
    the smoke config's 256-token vocabulary, every token gate
    teacher-forced. Fails unless every workload passes its gates, B1's
    launches (the kernel row's, warm-up included) are a positive multiple
    of the depth, B1 equals its plain version on the kernel row's own
    inputs (one served decode step and one bucketed prefill forward,
    every layer, captured as the row served them), and every workload's
    host counters equal the smoke config's on the CPU
    (:func:`cpu_bench_counters`, a child process). Results go to
    ``chiprun_out/bench/`` for the phase only. Returns (B1 launches, run
    records)."""
    import concurrent.futures
    import gc
    import multiprocessing

    import torch
    from repro_torch.benchmarks import common
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.models import attention
    from repro_torch.models.transformer import init_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    print(f"[bench] card memory held before the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    src = str(Path(__file__).resolve().parent / "src")
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "bench"
    vocab = get_smoke_config("qwen2-72b").vocab_size
    rehearsal = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_future = rehearsal.submit(cpu_bench_counters, seed, src)
        cfg = dataclasses.replace(get_config("qwen2-72b"),
                                  num_layers=BENCH_LAYERS)
        t0 = time.perf_counter()
        model = init_model(cfg, seed=seed, device="cuda")
        torch.cuda.synchronize()
        print(f"[bench] qwen2-72b at published widths: d_model "
              f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
              f"{cfg.dtype}; cut: depth 80 -> {cfg.num_layers} layers; "
              f"traces drawn from the smoke config's {vocab} token ids; "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the "
              f"card, init {time.perf_counter() - t0:.1f} s", flush=True)
        # only the kernel row reaches these entries: its inputs are kept
        # for B1 against plain below
        cap = B1Capture(attention.paged_kv_attention_decode,
                        at=BENCH_DECODE_AT * cfg.num_layers,
                        layers=cfg.num_layers)
        chunk_cap = B1ChunkCapture(attention.paged_kv_attention_chunk,
                                   layers=cfg.num_layers, S=BENCH_PREFILL_S,
                                   past_start=False, skip=BENCH_PREFILL_SKIP)
        attention.paged_kv_attention_decode = cap
        attention.paged_kv_attention_chunk = chunk_cap
        # the main path: counts zeroed just before, read just after
        paged_kv_attention_chunk.launches = 0
        try:
            with common.results_in(out_dir):
                res, secs = bench_workloads(cfg, model, vocab=vocab,
                                            teacher_force=True, verbose=True)
        finally:
            attention.paged_kv_attention_decode = cap.fn
            attention.paged_kv_attention_chunk = chunk_cap.fn
        launches = paged_kv_attention_chunk.launches
        del model
        gc.collect()
        torch.cuda.empty_cache()
        t_card = time.perf_counter() - t_phase
        cpu = cpu_future.result()
    finally:
        rehearsal.shutdown(wait=True, cancel_futures=True)
    kernel_row = res["mixed"]["rows"][-1]
    assert kernel_row["attn_impl"] == "kernel"
    if not launches or launches % cfg.num_layers:
        raise AssertionError(f"[bench] B1 launches {launches}: not a "
                             f"positive multiple of {cfg.num_layers} layers")
    print(f"[bench] main path: {launches} B1 launches = {cfg.num_layers} "
          f"layers x {launches // cfg.num_layers} programs of the "
          f"paged-int8-kernel row (warm-up included; "
          f"{kernel_row['prefill_forwards']} prefill forwards after it)",
          flush=True)
    what = (f"(paged-int8-kernel) kv_bits=8 "
            f"G={cfg.num_heads // cfg.num_kv_heads}")
    step = cap.saved[0] if cap.saved else None
    if step is not None:
        kv = step["kv_len"]
        print(f"[bench] {what}: decode step {BENCH_DECODE_AT + 1} captured, "
              f"{kv.numel()} rows of {int(kv.min())}-{int(kv.max())} keys, "
              f"a {step['k_pages'].shape[0]}-page pool", flush=True)
    b1 = {"decode": check_captured_b1(cap.saved, what, tag="[bench]"),
          "prefill": check_captured_b1_chunk(chunk_cap.saved, what,
                                             tag="[bench]")}
    for w, r in res.items():
        agree = ", ".join(f"{k} {v:.4f}" for k, v in _agreements(r).items())
        print(f"[bench] {w}: gates passed ({agree}); {secs[w]:.1f} s",
              flush=True)
    for w, got in bench_counters(res).items():
        print(f"[bench] {w} counters: {json.dumps(got)}", flush=True)
        if got != cpu[w]:
            raise AssertionError(f"[bench] {w}: counters {got} != CPU "
                                 f"{cpu[w]}")
    moved = {k: (v, cpu["adapt"][k]) for k, v in cpu["adapt@smoke"].items()
             if cpu["adapt"][k] != v}
    print("[bench] host counters equal the same benches' on the CPU for the "
          "same token traces: qwen2-72b-smoke's for every workload but "
          "adapt, whose byte-bounded quant tier is held against the smoke "
          f"config at qwen2-72b's KV geometry (the smoke geometry's "
          f"differ: {moved}); the predictor-on arm left out", flush=True)
    off, on = (res["traffic"]["predictor_off"],
               res["traffic"]["predictor_on"])
    print(f"[bench] traffic predictor on vs off: goodput {on['goodput']:.4f}"
          f" vs {off['goodput']:.4f}, {on['predictor_gated']} admissions "
          f"gated, {on['predictor_updates']} updates", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"[bench] phase {wall:.1f} s against a {BENCH_BUDGET_S} s budget "
          f"(card runs and model init {t_card:.1f} s; the CPU rehearsal "
          f"beside them)", flush=True)
    record = {"phase": "bench", "layers": cfg.num_layers, "results": res,
              "seconds": secs, "cpu_counters": cpu, "phase_s": wall,
              "budget_s": BENCH_BUDGET_S, "b1_launches": launches,
              "b1_vs_plain": b1}
    return launches, [record]


# ---------------------------------------------------------------------------
# [replicas]: the replica frontend on one card, and the mesh path at world
# size 1 on NCCL
# ---------------------------------------------------------------------------
REPLICAS_LAYERS = 4                 # qwen2-72b's 80 cut to fit ~45 s
REPLICAS_BUDGET_S = 45
REPLICAS_DECODE_AT = 10             # the captured decode step of (c)
REPLICAS_ARMS = ("1 replica", "2 replicas", "1 replica, teacher-forced",
                 "2 replicas, teacher-forced")
# (c)'s server: run_replicas's settings through B1, with page scales (their
# absmax goes through the mesh's max all-reduce)
REPLICAS_MESH = dict(batch_size=3, max_len=64, page_size=8, num_pages=10,
                     kv_bits=8, kv_scale="page", prefix_cache="on",
                     kv_offload="host", sched="slo", preempt=False,
                     metrics="on", pager_async="on", attn_impl="kernel",
                     kv_adapt="on")
# and, on its 9 usable pages, the quant tier: cold cached pages narrowed
# int8 -> int4 (10 requantizations, 1 restore on the CPU at the card's KV
# geometry) beside the host tier's demotions


class FrontendMeter:
    """Wraps ``ReplicaFrontend.run`` while installed: per call its
    replicas, B1 launches, generated tokens, host seconds (ended by a
    device sync) and peak device memory."""

    def __init__(self):
        from repro_torch.launch.frontend import ReplicaFrontend
        self.cls, self.fn, self.runs = ReplicaFrontend, ReplicaFrontend.run, []

    def __enter__(self):
        import torch
        from repro_torch.kernels.paged_kv_attention import \
            paged_kv_attention_chunk as b1
        meter = self

        def run(fe, requests, keys=None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            n0, t0 = b1.launches, time.perf_counter()
            out = meter.fn(fe, requests, keys)
            torch.cuda.synchronize()
            meter.runs.append({
                "replicas": len(fe.servers),
                "seconds": time.perf_counter() - t0,
                "b1_launches": b1.launches - n0,
                "gen_tokens": sum(len(r.out) for r in requests),
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
            return out

        self.cls.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self.fn


def replica_counters(res: dict) -> dict:
    """Each arm's frontend and namespaced replica host counters."""
    return {arm: res[arm]["counters"] for arm in ("one_replica",
                                                  "two_replica")}


def cpu_replica_counters(seed: int, src: str) -> dict:
    """``run_replicas`` on qwen2-72b's smoke config at the card's KV
    geometry (8 KV heads of 128, one layer) on the CPU, on the same trace,
    teacher-forced and through B1's plain version as the card's: its arms'
    host counters. Runs in a child process beside the card runs."""
    import tempfile
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    from repro_torch.benchmarks import common, traffic
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config("qwen2-72b")
    full = get_config("qwen2-72b")
    geo = dataclasses.replace(cfg, num_layers=1, num_heads=full.num_kv_heads,
                              num_kv_heads=full.num_kv_heads,
                              head_dim=full.head_dim)
    with tempfile.TemporaryDirectory() as tmp, common.results_in(tmp):
        res = traffic.run_replicas(
            geo, init_model(geo, seed=seed, device="cpu"), fast=True,
            teacher_force=True, vocab=cfg.vocab_size, attn_impl="kernel",
            verbose=False)
    return replica_counters(res)


def replicas_phase(seed: int):
    """``[replicas]``: qwen2-72b at its published widths cut to
    ``REPLICAS_LAYERS`` layers (bf16, seeded weights) on the reference's
    overload trace at ``--fast`` (its ids from the smoke config's
    vocabulary), every server through B1 with int8 pages, the prefix
    cache, the host tier, SLO scheduling and the async pager:

    (a) the 1-replica frontend against the plain server, bit for bit in
        tokens, done flags and finish steps (``run_replicas``'s gate);
    (b) 1 against 2 replicas sharing the card and the weights
        (``benchmarks.traffic.run_replicas``, teacher-forced): per arm the
        routing counters, goodput, tok/s, peak memory and B1 launches;
        2-replica goodput strictly above 1-replica; each arm's counters
        (the frontend's and each namespaced replica's) equal to the CPU
        rehearsal's (:func:`cpu_replica_counters`, a child process);
    (c) ``BatchedServer(mesh=make_serving_mesh(1))`` on a one-rank NCCL
        group against the plain server (page scales, the host tier and
        the quant tier on): the same tokens bit for bit and the same host
        counters, the quant tier's among them (it must requantize), and
        the same peak tier bytes; B1 against its plain version on one
        captured decode step of the mesh run, every layer.

    Returns (B1 launches, run records)."""
    import concurrent.futures
    import gc
    import multiprocessing

    import torch
    import torch.distributed as dist
    from repro_torch.benchmarks import common, traffic
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.core.traffic import generate_trace
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import BatchedServer
    from repro_torch.models import attention
    from repro_torch.models.transformer import init_model

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    src = str(Path(__file__).resolve().parent / "src")
    out_dir = Path(__file__).resolve().parent / "chiprun_out" / "replicas"
    vocab = get_smoke_config("qwen2-72b").vocab_size
    rehearsal = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_future = rehearsal.submit(cpu_replica_counters, seed, src)
        cfg = dataclasses.replace(get_config("qwen2-72b"),
                                  num_layers=REPLICAS_LAYERS)
        t0 = time.perf_counter()
        model = init_model(cfg, seed=seed, device="cuda")
        torch.cuda.synchronize()
        print(f"[replicas] qwen2-72b at published widths: d_model "
              f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
              f"{cfg.dtype}; cut: depth 80 -> {cfg.num_layers} layers; the "
              f"overload trace (--fast) drawn from the smoke config's "
              f"{vocab} token ids; "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB of "
              f"weights, init {time.perf_counter() - t0:.1f} s", flush=True)
        # the main path: counts zeroed just before, read just after
        paged_kv_attention_chunk.launches = 0
        t_b = time.perf_counter()
        with FrontendMeter() as meter, common.results_in(out_dir):
            res = traffic.run_replicas(cfg, model, fast=True,
                                       teacher_force=True, vocab=vocab,
                                       attn_impl="kernel", verbose=True)
        t_b = time.perf_counter() - t_b
        launches_b = paged_kv_attention_chunk.launches
        # (c) the mesh path at world size 1
        trace = generate_trace(traffic.overload_trace_config(vocab,
                                                             fast=True))
        plain = BatchedServer(cfg, model, device="cuda", **REPLICAS_MESH)
        want = plain.run(traffic.to_requests(trace))
        cap = B1Capture(attention.paged_kv_attention_decode,
                        at=REPLICAS_DECODE_AT * cfg.num_layers,
                        layers=cfg.num_layers)
        mesh = make_serving_mesh(1, device="cuda")
        attention.paged_kv_attention_decode = cap
        try:
            backend = dist.get_backend()
            srv = BatchedServer(cfg, model, mesh=mesh, device="cuda",
                                **REPLICAS_MESH)
            got = srv.run(traffic.to_requests(trace))
            torch.cuda.synchronize()
        finally:
            attention.paged_kv_attention_decode = cap.fn
            dist.destroy_process_group()
        launches = paged_kv_attention_chunk.launches
        c_plain, c_mesh = host_counters(plain), host_counters(srv)
        tier_bytes = {"plain": plain.quant_tier.peak_bytes,
                      "mesh": srv.quant_tier.peak_bytes}
        del model, plain, srv
        gc.collect()
        torch.cuda.empty_cache()
        t_card = time.perf_counter() - t_phase
        cpu = cpu_future.result()
    finally:
        rehearsal.shutdown(wait=True, cancel_futures=True)
    # (a): run_replicas raised unless the 1-replica frontend was the plain
    # server in tokens, done flags and finish steps
    print(f"[replicas] (a) the 1-replica frontend is the plain server: "
          f"{res['trace']['requests']} requests, tokens, done flags and "
          f"finish steps equal bit for bit", flush=True)
    if len(meter.runs) != len(REPLICAS_ARMS):
        raise AssertionError(f"[replicas] {len(meter.runs)} frontend runs, "
                             f"want {len(REPLICAS_ARMS)}")
    arms = {}
    for label, run, key in zip(REPLICAS_ARMS, meter.runs,
                               ("one_replica", "two_replica") * 2):
        r = res[key]
        c = r["counters"]
        run["tok_s"] = run["gen_tokens"] / run["seconds"]
        arms[label] = run
        if not run["b1_launches"] or run["b1_launches"] % cfg.num_layers:
            raise AssertionError(f"[replicas] {label}: B1 launches "
                                 f"{run['b1_launches']}, not a positive "
                                 f"multiple of {cfg.num_layers} layers")
        routed = [c.get(f"frontend.routed_replica{i}", 0)
                  for i in range(run["replicas"])]
        print(f"[replicas] (b) {label}: routed {routed}, "
              f"{c.get('frontend.affinity_hits', 0)} affinity hits, "
              f"{c.get('frontend.rebalanced', 0)} rebalances, "
              f"{c.get('frontend.shared_prefix_pages', 0)} shared prefix "
              f"pages; goodput {r['goodput']:.4f}; {run['gen_tokens']} "
              f"tokens in {run['seconds']:.2f} s = {run['tok_s']:.1f} "
              f"tok/s; peak {run['peak_gib']:.2f} GiB; "
              f"{run['b1_launches']} B1 launches", flush=True)
    g1, g2 = res["one_replica"]["goodput"], res["two_replica"]["goodput"]
    if not g2 > g1:
        raise AssertionError(f"[replicas] 2-replica goodput {g2} <= {g1}")
    got_c = replica_counters(res)
    for arm in got_c:
        if got_c[arm] != cpu[arm]:
            diff = {k: (got_c[arm].get(k), cpu[arm].get(k))
                    for k in set(got_c[arm]) | set(cpu[arm])
                    if got_c[arm].get(k) != cpu[arm].get(k)}
            raise AssertionError(f"[replicas] {arm} counters differ from "
                                 f"the CPU rehearsal's: {diff}")
    print(f"[replicas] (b) goodput 2 replicas {g2:.4f} > 1 replica "
          f"{g1:.4f}; teacher-forced agreement "
          f"{res['one_replica']['token_agreement']:.4f} / "
          f"{res['two_replica']['token_agreement']:.4f} (free-running "
          f"{res['one_replica']['token_agreement_free_running']:.4f} / "
          f"{res['two_replica']['token_agreement_free_running']:.4f}); "
          f"every counter of both arms ({len(got_c['two_replica'])} in the "
          f"2-replica arm) equals the CPU rehearsal's; {t_b:.1f} s",
          flush=True)
    # (c)
    if [list(r.out) for r in got] != [list(r.out) for r in want] or \
            [(r.done, r.finish_step) for r in got] != \
            [(r.done, r.finish_step) for r in want]:
        raise AssertionError("[replicas] (c) the world-size-1 mesh server's "
                             "tokens differ from the plain server's")
    if c_mesh != c_plain:
        raise AssertionError(f"[replicas] (c) counters {c_mesh} != "
                             f"{c_plain}")
    tier = {k: c_mesh[f"prefix.{k}"] for k in ("requants", "deepens",
                                                "tier_promotions")}
    if not tier["requants"] or tier_bytes["mesh"] != tier_bytes["plain"]:
        raise AssertionError(f"[replicas] (c) the quant tier: {tier}, peak "
                             f"bytes {tier_bytes}")
    b1 = check_captured_b1(cap.saved, f"(c) mesh=make_serving_mesh(1) on "
                           f"{backend}, kv_bits=8 page scales G="
                           f"{cfg.num_heads // cfg.num_kv_heads}",
                           tag="[replicas]")
    print(f"[replicas] (c) BatchedServer(mesh=make_serving_mesh(1)) on a "
          f"one-rank {backend} group: {len(got)} requests, tokens equal the "
          f"plain server's bit for bit, {len(c_mesh)} counters equal; "
          f"the quant tier {tier}, its peak bytes {tier_bytes['mesh']} "
          f"(the whole pool's) as the plain server's; "
          f"{launches - launches_b} B1 launches", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"[replicas] main path: {launches} B1 launches; phase "
          f"{wall:.1f} s against a {REPLICAS_BUDGET_S} s budget (card runs "
          f"and model init {t_card:.1f} s; the CPU rehearsal beside them)",
          flush=True)
    record = {"phase": "replicas", "layers": cfg.num_layers, "results": res,
              "arms": arms, "cpu_counters": cpu, "mesh_backend": backend,
              "mesh_counters": c_mesh, "mesh_tier": tier,
              "mesh_tier_peak_bytes": tier_bytes, "b1_launches": launches,
              "b1_vs_plain": b1, "phase_s": wall,
              "budget_s": REPLICAS_BUDGET_S}
    return launches, [record]


# ---------------------------------------------------------------------------
# [train]: deepseek-7b trained at published widths, then served through B1
# ---------------------------------------------------------------------------
TRAIN_ARCH = "deepseek-7b"
# deepseek-7b's 30 layers cut to 8: at 30 the float32 masters, gradients
# and fp32 moments alone take ~110 GB
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 20, 5, 3e-4
TRAIN_TIMED_FROM = 2                # step index of the first timed step
TRAIN_PROFILED = (3, 5)             # arm 1's profiled steps [from, to)
TRAIN_INSTRUMENTED = 3              # lr-0 steps after an arm, AdamW timed
TRAIN_SMOKE_STEPS = 5
TRAIN_PEAK_GIB = 80 * 1e9 / 2 ** 30  # the card's 80 GB
TRAIN_SERVE = dict(batch_size=4, max_len=288, page_size=PS)
TRAIN_TRAFFIC = dict(n=8, lo=64, hi=256, max_new=16)
TRAIN_BUDGET_S = 60


def train_data(cfg, *, batch: int, seq: int, seed: int):
    from repro_torch.data.lm import LMDataConfig
    return LMDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                        batch_size=batch, seed=seed + 1)


def shared_adamw(model, seed: int, device) -> dict:
    """Two int8-moment AdamW updates of ``model``'s parameters (weights
    made on the CPU, so both devices start from the same numbers) by
    gradients drawn with numpy from ``seed``, on ``device``: the updated
    parameters and moment grids as numpy arrays."""
    import torch
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update)
    rng = np.random.default_rng(seed + 7)
    params = {n: p.detach().clone().to(device)
              for n, p in model.named_parameters()}
    cfg = AdamWConfig(quantize_moments=True)
    st = adamw_init(params, cfg)
    for _ in range(2):
        grads = {n: torch.from_numpy(rng.normal(
            0, 0.02, p.shape).astype(np.float32)).to(device)
            for n, p in params.items()}
        adamw_update(params, grads, st, 1e-3, cfg)
    return {n: (params[n].cpu().numpy(), st["m"][n]["q"].cpu().numpy(),
                st["v"][n]["q"].cpu().numpy()) for n in params}


def smoke_train(seed: int, device: str) -> dict:
    """(a) on ``device``: ``TRAIN_SMOKE_STEPS`` ``make_train_step`` steps
    of deepseek-7b-smoke (float32) from the seed's weights made on the
    CPU, on the same ``lm_batch`` batches; each step's loss and grad norm;
    then :func:`shared_adamw` on the initial weights."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          make_train_step)
    from repro_torch.models.transformer import init_model
    cfg = get_smoke_config(TRAIN_ARCH)
    dcfg = train_data(cfg, batch=4, seq=64, seed=seed)
    model = init_model(cfg, seed=seed, device="cpu", trainable=True)
    adamw = shared_adamw(model, seed, device)
    model = model.to(device)
    hp = TrainHParams(lr=1e-3)
    state = init_train_state(cfg, hp, model=model)
    step = make_train_step(cfg, hp)
    out = []
    for i in range(TRAIN_SMOKE_STEPS):
        b = {k: v.to(device) for k, v in lm_batch(dcfg, i).items()}
        state, m = step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    if device != "cpu":
        torch.cuda.synchronize()
    return {"steps": out, "adamw": adamw}


def cpu_smoke_train(seed: int, src: str) -> dict:
    """:func:`smoke_train` on the CPU, in a child process, one thread."""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    return smoke_train(seed, "cpu")


def train_card_vs_cpu(seed: int, cpu_future) -> dict:
    """(a): the smoke config trained on the card (TF32 off) against the
    CPU: per step loss and grad norm within rtol 1e-5; AdamW fed the same
    gradients: parameters within 1e-6, int8 moment grids equal but for
    one-step flips at rounding ties (counted, at most 0.1%)."""
    card = smoke_train(seed, "cuda")
    cpu = cpu_future.result()
    worst = 0.0
    for i, ((lc, gc), (lh, gh)) in enumerate(zip(card["steps"],
                                                cpu["steps"])):
        for a, b, what in ((lc, lh, "loss"), (gc, gh, "grad_norm")):
            rel = abs(a - b) / max(abs(b), 1e-30)
            worst = max(worst, rel)
            if rel > 1e-5:
                raise AssertionError(f"[train] (a) step {i + 1} {what}: "
                                     f"card {a!r} CPU {b!r}")
    perr, flips, n = 0.0, 0, 0
    for name, (p, mq, vq) in card["adamw"].items():
        p0, mq0, vq0 = cpu["adamw"][name]
        perr = max(perr, float(np.abs(p - p0).max()))
        for a, b in ((mq, mq0), (vq, vq0)):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            if d.max() > 1:
                raise AssertionError(f"[train] (a) {name}: int8 moments "
                                     f"differ by {d.max()} steps")
            flips += int((d != 0).sum())
            n += d.size
    if perr > 1e-6 or flips > 1e-3 * n:
        raise AssertionError(f"[train] (a) AdamW on shared gradients: "
                             f"params {perr:.3e}, {flips} moment flips")
    for i, ((lc, gc), (lh, gh)) in enumerate(zip(card["steps"],
                                                cpu["steps"])):
        print(f"[train] (a) {TRAIN_ARCH}-smoke step {i + 1}: loss card "
              f"{lc:.7f} CPU {lh:.7f}, grad norm card {gc:.7f} CPU "
              f"{gh:.7f}", flush=True)
    print(f"[train] (a) card vs CPU: largest relative difference {worst:.2e}"
          f" (limit 1e-5); AdamW with int8 moments on shared gradients, 2 "
          f"steps: params max abs diff {perr:.2e} (limit 1e-6), {flips} of "
          f"{n} moment grid values one step apart", flush=True)
    return {"steps_card": card["steps"], "steps_cpu": cpu["steps"],
            "worst_rel": worst, "adamw_param_err": perr,
            "adamw_moment_flips": flips, "adamw_moment_values": n}


class SyncTimer(StepTimer):
    """:class:`StepTimer` that waits for the device before each call, so
    each event pair brackets the call's own device work: an eager train
    step lets the host run ahead, and an unsynchronized pair would also
    time the queue of earlier work."""

    def __call__(self, *a, **kw):
        import torch
        torch.cuda.synchronize()
        return super().__call__(*a, **kw)


def card_clocks() -> str:
    """The card's SM clock against its maximum, power draw and
    temperature, as ``nvidia-smi`` reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip().splitlines()[0]


def state_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(state_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    """One (b)-style arm's schedule, data and printing: ``steps`` at
    ``lr`` with a ``warmup``-step cosine warm-up on ``batch`` x ``seq``
    positions (``lm_batch`` tokens, or with ``embeds`` the stub frontend's
    batches of ``configs.shapes.make_batch``), timed from step index
    ``timed_from``, a ``torch.profiler`` window over ``profiled`` [from,
    to), ``instrumented`` lr-0 steps after; lines printed under
    ``tag``."""

    tag: str = "[train]"
    steps: int = TRAIN_STEPS
    warmup: int = TRAIN_WARMUP
    lr: float = TRAIN_LR
    batch: int = TRAIN_BATCH
    seq: int = TRAIN_SEQ
    timed_from: int = TRAIN_TIMED_FROM
    profiled: tuple = TRAIN_PROFILED
    instrumented: int = TRAIN_INSTRUMENTED
    embeds: bool = False


def train_batches(cfg, spec: TrainSpec, seed: int):
    """fn(step) -> the step's batch on the host: ``lm_batch`` tokens, or
    ``make_batch``'s stub-frontend batch drawn from a generator seeded by
    (seed, step)."""
    from repro_torch.data.lm import lm_batch
    if not spec.embeds:
        dcfg = train_data(cfg, batch=spec.batch, seq=spec.seq, seed=seed)
        return lambda s: lm_batch(dcfg, s)
    import torch
    from repro_torch.configs.shapes import SHAPES, make_batch
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=spec.seq)
    return lambda s: make_batch(
        cfg, shape, generator=torch.Generator().manual_seed(
            seed * 100_003 + s), device="cpu", batch_override=spec.batch)


def train_arm(cfg, label: str, seed: int, *, quant=None, int8: bool,
              profile: bool, spec: TrainSpec = TrainSpec(),
              state_grads: bool = False) -> dict:
    """One arm of (b): ``spec.steps`` steps from the seed's random
    trainable model at lr ``spec.lr``, cosine warm-up ``spec.warmup``, on
    the port's pipeline (:func:`train_batches`). Each step is timed alone:
    one device sync, then CUDA events around the step
    (:class:`SyncTimer`); each batch's ``next(pipe)`` (built on the host,
    in this thread) by the host clock. With ``profile``, a
    ``torch.profiler`` window over ``spec.profiled``. Then
    ``spec.instrumented`` more steps with AdamW (and the wire) timed by
    events after a device sync each, which splits the step but adds its
    syncs: those steps' ms are printed apart, and the losses, step ms and
    profile come from the uninstrumented steps. They run at lr 0, the
    same work with the weights left as the ``spec.steps`` made them (the
    moments move). With the int8 wire, step 1's raw gradient of every
    block matrix is checked nonzero (C5). With ``state_grads``, step 1's
    gradient reaching each recurrent state through its grid at a chunk
    boundary (the input of ``ssm._maybe_fake_quant``) is checked nonzero
    (C8). Returns its record and the trained model."""
    import torch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import ssm
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import CompressionConfig
    from repro_torch.optim.schedule import cosine_warmup

    tag = spec.tag
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hp = steps_mod.TrainHParams(
        lr=spec.lr, adamw=AdamWConfig(quantize_moments=int8),
        grad_compress=CompressionConfig() if int8 else None)
    model = init_model(cfg, seed=seed, device="cuda", trainable=True)
    state = steps_mod.init_train_state(cfg, hp, model=model)
    init_s = time.perf_counter() - t0
    opt_bytes = state_bytes(state["opt"]["m"]) + state_bytes(
        state["opt"]["v"])
    ef_bytes = state_bytes(state.get("ef_residual", {}))
    pipe = DataPipeline(train_batches(cfg, spec, seed), device="cuda")
    lr_fn = cosine_warmup(spec.lr, spec.warmup, spec.steps)
    real_opt, real_wire = steps_mod.adamw_update, steps_mod.compress_gradients
    real_grid = ssm._maybe_fake_quant
    opt, wire = SyncTimer(real_opt), SyncTimer(real_wire)
    timed = SyncTimer(lambda state, batch, lr: step(state, batch, lr=lr))
    inst = SyncTimer(lambda state, batch, lr: step(state, batch, lr=lr))
    seen, grid_grads = {}, []

    def first_grads(grads, res, ccfg, **kw):
        if not seen:
            seen.update({n: bool(g.any()) for n, g in grads.items()})
        return real_wire(grads, res, ccfg, **kw)

    def grid_spy(x, q):
        # the pre-grid state's gradient: it fires only where a later
        # chunk reads the state (the final state is not trained on)
        if q is not None and x.requires_grad:
            rec = []
            grid_grads.append(rec)
            x.register_hook(lambda g, rec=rec: rec.append(g.abs().amax()))
        return real_grid(x, q)

    steps_mod.compress_gradients = first_grads
    step = steps_mod.make_train_step(cfg, hp, quant=quant)
    losses, data_ms, prof = [], [], None
    try:
        for i in range(spec.steps):
            td = time.perf_counter()
            batch = next(pipe)
            data_ms.append((time.perf_counter() - td) * 1e3)
            if profile and i == spec.profiled[0]:
                from torch.profiler import ProfilerActivity, profile as prf
                torch.cuda.synchronize()
                prof = prf(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                tw = time.perf_counter()
            ssm._maybe_fake_quant = grid_spy if (state_grads and i == 0) \
                else real_grid
            state, m = timed(state, batch, lr_fn(i))
            losses.append(m["loss"])
            if prof is not None and i == spec.profiled[1] - 1:
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - tw) * 1e6
                prof.__exit__(None, None, None)
        ssm._maybe_fake_quant = real_grid
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - init_s
        steps_mod.adamw_update, steps_mod.compress_gradients = opt, wire
        for _ in range(spec.instrumented):     # lr 0: the weights stay
            state, _ = inst(state, next(pipe), 0.0)
        torch.cuda.synchronize()
    finally:
        steps_mod.adamw_update = real_opt
        steps_mod.compress_gradients = real_wire
        ssm._maybe_fake_quant = real_grid
    clocks = card_clocks()
    losses = [float(x) for x in losses]

    def median_ms(t, start=0):
        """The median of a timer's calls' ms from call ``start``."""
        ms = [a.elapsed_time(b) for a, b, _ in t.pairs][start:]
        return float(np.median(ms)) if ms else None

    step_ms = [a.elapsed_time(b) for a, b, _ in timed.pairs]
    med = median_ms(timed, spec.timed_from)
    opt_ms, wire_ms, inst_ms = median_ms(opt), median_ms(wire), \
        median_ms(inst)
    data_med = float(np.median(data_ms[spec.timed_from:]))
    tokens = spec.batch * spec.seq
    last = min(5, spec.steps // 2)
    rec = {"label": label, "losses": losses, "step_ms": step_ms,
           "step_ms_median": med, "tok_per_s": tokens / med * 1e3,
           "data_ms": data_ms, "data_ms_median": data_med,
           "instrumented_step_ms_median": inst_ms,
           "optimizer_ms_median": opt_ms, "wire_ms_median": wire_ms,
           "optimizer_share_of_step": opt_ms / med,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "optimizer_state_bytes": opt_bytes,
           "ef_residual_bytes": ef_bytes, "init_s": init_s, "wall_s": wall,
           "clocks": clocks}
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag} ({label}) non-finite loss: {losses}")
    if not np.mean(losses[-last:]) < losses[0]:
        raise AssertionError(f"{tag} ({label}) the last {last} losses' mean"
                             f" {np.mean(losses[-last:])} is not below step "
                             f"1's {losses[0]}")
    if rec["peak_gib"] >= TRAIN_PEAK_GIB:
        raise AssertionError(f"{tag} ({label}) peak {rec['peak_gib']:.2f}"
                             f" GiB: over the card's 80 GB")
    mid = (spec.steps + 1) // 2
    print(f"{tag} ({label}) loss step 1 {losses[0]:.4f}, step {mid} "
          f"{losses[mid - 1]:.4f}, step {spec.steps} {losses[-1]:.4f} (mean "
          f"of the last {last} {np.mean(losses[-last:]):.4f}); step "
          f"{med:.1f} ms (median from step {spec.timed_from + 1}, CUDA "
          f"events), {rec['tok_per_s']:,.0f} tok/s; next(pipe) "
          f"{data_med:.2f} ms (median, host clock); {spec.instrumented} "
          f"instrumented steps {inst_ms:.1f} ms (median): AdamW "
          f"{opt_ms:.1f} ms = {rec['optimizer_share_of_step']:.3f} of the "
          f"uninstrumented step"
          + (f", int8 wire {wire_ms:.1f} ms" if wire_ms else "")
          + f"; peak {rec['peak_gib']:.2f} GiB; optimizer state "
          f"{opt_bytes / 1e9:.2f} GB"
          + (f" + error-feedback residual {ef_bytes / 1e9:.2f} GB"
             if ef_bytes else "")
          + f"; init {init_s:.1f} s, {spec.steps} steps {wall:.1f} s; "
          f"SM clock, max, power, temperature after the steps: {clocks}",
          flush=True)
    if int8:
        blocks = [n for n, p in model.named_parameters()
                  if n.startswith("layers.") and p.dim() >= 2]
        dead = [n for n in blocks if not seen.get(n)]
        if dead:
            raise AssertionError(f"{tag} ({label}) block matrices with a "
                                 f"zero gradient at step 1 (C5): {dead}")
        rec["block_matrices_with_gradient"] = len(blocks)
        print(f"{tag} ({label}) step 1: all {len(blocks)} block matrices "
              f"have a nonzero gradient (the straight-through fake-quant, "
              f"C5)", flush=True)
    if state_grads:
        fired = [float(r[0]) for r in grid_grads if r]
        grids = sum(1 for li, (kind, _) in enumerate(
            b.sig for b in model.layers) if kind in ("mamba", "mlstm")
            and quant is not None and quant.layer_state(li) is not None)
        if len(fired) != grids * (spec.seq // min(cfg.ssm_chunk, spec.seq)
                                  - 1) or not all(f > 0 for f in fired):
            raise AssertionError(f"{tag} ({label}) step 1: the gradient "
                                 f"through the state grid reached "
                                 f"{sum(f > 0 for f in fired)} of {grids} "
                                 f"layers' chunk boundaries (C8)")
        rec["state_boundaries_with_gradient"] = len(fired)
        print(f"{tag} ({label}) step 1: the gradient reaches the state "
              f"before the grid at all {len(fired)} chunk boundaries "
              f"({grids} layers, state {quant.layer_state(0)}), largest "
              f"{max(fired):.3e}, smallest {min(fired):.3e} (the "
              f"straight-through state grid, C8)", flush=True)
    if prof is not None:
        evs, busy, by_name = device_activity(prof)
        n = spec.profiled[1] - spec.profiled[0]
        if not evs:
            print(f"{tag} ({label}) torch.profiler recorded no device "
                  f"activity", flush=True)
        else:
            kernel_us = sum(t for _, t in by_name.values())
            rec["profile"] = {
                "steps": n, "window_ms_a_step": window_us / n / 1e3,
                "device_busy_ms_a_step": busy / n / 1e3,
                "device_idle_share": 1.0 - busy / window_us,
                "kernels_a_step": len(evs) / n,
                "top": sorted(((t / n, c // n, k[:70]) for k, (c, t)
                               in by_name.items()), reverse=True)[:5]}
            p = rec["profile"]
            print(f"{tag} ({label}) profiled steps {spec.profiled[0] + 1}"
                  f"-{spec.profiled[1]}: {p['window_ms_a_step']:.1f} ms a "
                  f"step (host clock), device busy "
                  f"{p['device_busy_ms_a_step']:.1f} ms, idle share "
                  f"{p['device_idle_share']:.3f}; {p['kernels_a_step']:.0f} "
                  f"device kernels a step ({kernel_us / n / 1e3:.1f} ms of "
                  f"kernel time)", flush=True)
            for t, c, k in p["top"]:
                print(f"{tag}   {t / 1e3:8.3f} ms in {c:5d} x {k}",
                      flush=True)
    return rec, model


def train_resume_check(seed: int) -> dict:
    """(c) on the card: the smoke config trained 6 steps under
    ``TrainSupervisor`` with a checkpoint every 3 steps and a
    ``FaultInjection`` at step 4 (restored from step 3, the pipeline
    rewound to it), against 6 uninterrupted steps: final loss within rtol
    1e-4; the parameters' max difference and whether they are bitwise
    equal. Then a bf16 copy of the card state's parameters round-trips a
    checkpoint bit for bit (C6)."""
    import tempfile

    import torch
    from repro_torch.checkpoint.ckpt import (CheckpointManager,
                                             restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.lm import lm_batch
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          load_train_state, make_train_step,
                                          train_state_tree)
    from repro_torch.models.transformer import init_model
    from repro_torch.runtime.fault import FaultInjection, TrainSupervisor

    cfg = get_smoke_config(TRAIN_ARCH)
    dcfg = train_data(cfg, batch=4, seq=64, seed=seed)
    hp = TrainHParams(lr=1e-3)
    step_fn = make_train_step(cfg, hp)

    def fresh():
        model = init_model(cfg, seed=seed, device="cuda", trainable=True)
        return init_train_state(cfg, hp, model=model)

    state = fresh()
    pipe = DataPipeline(lambda s: lm_batch(dcfg, s), device="cuda")
    for _ in range(6):
        state, m = step_fn(state, next(pipe))
    straight = float(m["loss"])
    ref = {n: p.detach().clone() for n, p in
           state["params"].named_parameters()}

    with tempfile.TemporaryDirectory() as d:
        state = fresh()
        pipe = DataPipeline(lambda s: lm_batch(dcfg, s), device="cuda")
        ckpt = CheckpointManager(d, interval=3)
        template = train_state_tree(state, cfg, device="meta")
        fail = {4}

        def one_step(st, step):
            if step in fail:
                fail.discard(step)
                raise FaultInjection(f"node lost at step {step}")
            return step_fn(st, next(pipe))

        def save_hook(step, st):
            ckpt.maybe_save(step, train_state_tree(st, cfg),
                            extra={"data": {"step": step}})

        def restore_fn():
            step, tree, extra = ckpt.restore_latest(template)
            load_train_state(state, tree, cfg)
            pipe.restore(extra["data"])
            return step, state

        sup = TrainSupervisor(step_fn=one_step, save_hook=save_hook,
                              restore_fn=restore_fn)
        state, metrics = sup.run(state, 0, 6)
        ckpt.wait()
        resumed = float(metrics[-1]["loss"])
        diff = max(float((p.detach() - ref[n]).abs().max())
                   for n, p in state["params"].named_parameters())
        bitwise = all(torch.equal(p.detach(), ref[n])
                      for n, p in state["params"].named_parameters())
        if sup.restarts != 1 or abs(resumed - straight) > 1e-4 * abs(
                straight):
            raise AssertionError(f"[train] (c) resumed loss {resumed!r} vs "
                                 f"uninterrupted {straight!r}, "
                                 f"{sup.restarts} restarts")
        bf = {"params": {n: p.detach().to(torch.bfloat16) for n, p in
                         state["params"].named_parameters()}}
        save_checkpoint(str(Path(d) / "bf16"), 6, bf)
        _, back, _ = restore_checkpoint(str(Path(d) / "bf16"), bf,
                                        device="cuda")
        same = all(torch.equal(back["params"][n].view(torch.int16),
                               t.view(torch.int16))
                   for n, t in bf["params"].items())
        if not same:
            raise AssertionError("[train] (c) a bf16 checkpoint of the card "
                                 "state did not round-trip bit for bit")
    print(f"[train] (c) {TRAIN_ARCH}-smoke, 6 steps under TrainSupervisor, "
          f"checkpoint every 3, FaultInjection at step 4 (1 restart): final "
          f"loss {resumed:.7f} vs uninterrupted {straight:.7f}; parameters "
          f"max abs diff {diff:.3e}, "
          f"{'bitwise equal' if bitwise else 'not bitwise equal'}; a bf16 "
          f"checkpoint of the card state round-trips bit for bit (C6)",
          flush=True)
    return {"resumed_loss": resumed, "straight_loss": straight,
            "param_max_diff": diff, "bitwise": bitwise, "bf16_roundtrip":
            same}


def train_trace(cfg, seed: int, traffic=TRAIN_TRAFFIC):
    """``traffic``'s requests (8 of 64-256 prompt tokens, 16 new tokens
    each, by default) from the port's ``lm_batch`` (the corpus the
    decoders trained on)."""
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch.serve import Request
    t = traffic
    dcfg = train_data(cfg, batch=t["n"], seq=t["hi"], seed=seed)
    toks = lm_batch(dcfg, 10 ** 6)["tokens"].numpy()
    lens = np.random.default_rng(seed + 3).integers(t["lo"], t["hi"] + 1,
                                                    t["n"])
    return [Request(i, toks[i, :int(L)].copy(), t["max_new"])
            for i, L in enumerate(lens)]


def train_serve_check(cfg, tree, seed: int, *, tag: str = "[train]",
                      arch: str = TRAIN_ARCH, traffic=TRAIN_TRAFFIC):
    """(d): the trained weights (``params_to_numpy``, on the host) into a
    bf16 serving model (``params_from_numpy``), served by
    ``BatchedServer`` at page size 16, int8 KV, batch 4 on
    :func:`train_trace`'s ``traffic``: the gather route, the kernel route
    fed its tokens (gated, B1 held against plain on one captured decode
    step and one 32-query prefill forward, every layer, at the config's
    G), and the kernel route free-running (its agreement printed); lines
    under ``tag``. Returns (B1 launches, record)."""
    import gc

    import torch
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk
    from repro_torch.models import attention
    from repro_torch.models.transformer import params_from_numpy

    t0 = time.perf_counter()
    model = params_from_numpy(tree, cfg, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    L, G = cfg.num_layers, cfg.num_heads // cfg.num_kv_heads
    trace = lambda c, sd: train_trace(c, sd, traffic)      # noqa: E731
    runs, caps, launches = {}, {}, 0
    for label, impl, forced_by in (("gather", "gather", None),
                                   ("kernel", "kernel", "gather"),
                                   ("kernel-free", "kernel", None)):
        cap = chunk_cap = None
        if label == "kernel":
            cap = B1Capture(attention.paged_kv_attention_decode, at=6 * L,
                            layers=L)
            chunk_cap = B1ChunkCapture(attention.paged_kv_attention_chunk,
                                       layers=L, S=32)
            attention.paged_kv_attention_decode = cap
            attention.paged_kv_attention_chunk = chunk_cap
        forced = ({r.rid: r.out for r in runs[forced_by][0]}
                  if forced_by else None)
        paged_kv_attention_chunk.launches = 0
        try:
            reqs, st, _ = serve_once(cfg, model, kv_bits=8, attn_impl=impl,
                                     seed=seed, forced=forced, trace=trace,
                                     **TRAIN_SERVE)
        finally:
            if cap is not None:
                attention.paged_kv_attention_decode = cap.fn
                attention.paged_kv_attention_chunk = chunk_cap.fn
        n = paged_kv_attention_chunk.launches
        if impl == "kernel" and n != L * st["program_launches"]:
            raise AssertionError(f"{tag} (d) {label}: B1 launches {n} != "
                                 f"{L} layers x {st['program_launches']} "
                                 f"programs")
        if impl == "gather" and n:
            raise AssertionError(f"{tag} (d) the gather route launched "
                                 f"B1 {n} times")
        launches += n
        st["b1_launches"] = n
        runs[label] = (reqs, st)
        print(f"{tag} (d) {label}: {st['tok_per_s']:.1f} tok/s, decode "
              f"step {st['decode_step_ms']:.2f} ms x {st['decode_steps']}, "
              f"prefill forward {st['prefill_forward_ms']:.2f} ms x "
              f"{st['prefill_forwards']}, B1 x {n}, peak "
              f"{st['max_memory_allocated_gib']:.2f} GiB", flush=True)
        if cap is not None:
            what = f"(d) trained {arch} kv_bits=8 G={G}"
            caps = {"decode": check_captured_b1(cap.saved, what,
                                                tag=tag),
                    "prefill": check_captured_b1_chunk(chunk_cap.saved,
                                                       what, tag=tag)}
    gate = accuracy_gate([r.out for r in runs["gather"][0]],
                         [r.out for r in runs["kernel"][0]])
    free = decode_agreement([r.out for r in runs["gather"][0]],
                            [r.out for r in runs["kernel-free"][0]])
    print(f"{tag} (d) kernel vs gather route, teacher-forced: agreement "
          f"{gate['agreement']:.4f} ({gate['below_floor']} below 0.5) -> "
          f"{'pass' if gate['passed'] else 'FAIL'}; free-running "
          f"{free['overall']:.4f}; weights loaded in {load_s:.1f} s",
          flush=True)
    if not gate["passed"]:
        raise AssertionError(f"{tag} (d) fails the gate: {gate}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"runs": {k: v[1] for k, v in runs.items()},
                      "gate": gate["agreement"],
                      "free_running": free["overall"], "b1_vs_plain": caps,
                      "load_s": load_s}


def train_phase(seed: int):
    """``[train]``: (a) deepseek-7b-smoke trained on the card against the
    CPU (a child process) and AdamW on shared gradients; (b) deepseek-7b
    at published widths cut to ``TRAIN_LAYERS`` layers, two arms of
    ``TRAIN_STEPS`` steps at 4 x 512 tokens: fp32 moments (profiled), and
    the example's W10 / D12 / KV8 with int8 moments and the int8 gradient
    wire; (c) supervisor resume and a bf16 checkpoint on the card; (d)
    arm 1's weights served through B1 at G = 1. Float32 matmuls without
    TF32 (set by ``main``). Returns (B1 launches, records)."""
    import concurrent.futures
    import dataclasses as dc
    import gc
    import multiprocessing

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import build_quant
    from repro_torch.models.transformer import params_to_numpy

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    print(f"[train] card memory held before the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    src = str(Path(__file__).resolve().parent / "src")
    rehearsal = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    part_s = {}
    try:
        cpu_future = rehearsal.submit(cpu_smoke_train, seed, src)
        cfg = dc.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
        print(f"[train] {TRAIN_ARCH} at published widths: d_model "
              f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
              f"{cfg.dtype} compute over {cfg.param_dtype} masters; cut: "
              f"depth 30 -> {cfg.num_layers} layers "
              f"({cfg.param_count():,} parameters); batch {TRAIN_BATCH} x "
              f"{TRAIN_SEQ} tokens from lm_batch", flush=True)
        t0 = time.perf_counter()
        arm1, model = train_arm(cfg, "b1 fp32 moments", seed, int8=False,
                                profile=True)
        tree = params_to_numpy(model, cfg)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        quant = build_quant(cfg, weight_bits=10, data_bits=12, kv_bits=8,
                            policy_json="")
        arm2, model = train_arm(cfg, "b2 W10/D12/KV8 int8 moments int8 wire",
                                seed, quant=quant, int8=True, profile=False)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        part_s["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = train_card_vs_cpu(seed, cpu_future)
        part_s["a"] = time.perf_counter() - t0
    finally:
        rehearsal.shutdown(wait=True, cancel_futures=True)
    t0 = time.perf_counter()
    resume = train_resume_check(seed)
    part_s["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, serve = train_serve_check(cfg, tree, seed)
    part_s["d"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    print(f"[train] main path: {launches} B1 launches = layers x programs "
          f"over the kernel runs of (d); phase {wall:.1f} s against a "
          f"{TRAIN_BUDGET_S} s budget ((a) {part_s['a']:.1f}, (b) "
          f"{part_s['b']:.1f}, (c) {part_s['c']:.1f}, (d) {part_s['d']:.1f} "
          f"s)", flush=True)
    record = {"phase": "train", "layers": cfg.num_layers, "arms": [arm1, arm2],
              "card_vs_cpu": card, "resume": resume, "serve": serve,
              "b1_launches": launches, "phase_s": wall, "part_s": part_s,
              "budget_s": TRAIN_BUDGET_S}
    return launches, [record]


# ---------------------------------------------------------------------------
# [train2]: training the recurrent and encoder families and from embeddings
# ---------------------------------------------------------------------------
# (a)'s smoke cases: (label, arch, MoE dispatch or None, stub-frontend
# embeddings, int8 moments and the int8 wire)
TRAIN2_SMOKE = (
    ("xlstm-350m-smoke", "xlstm-350m", None, False, False),
    ("jamba-smoke eval_all", "jamba-v0.1-52b", "eval_all", False, False),
    ("jamba-smoke scatter", "jamba-v0.1-52b", "scatter", False, False),
    ("hubert-xlarge-smoke frames", "hubert-xlarge", None, True, False),
    ("qwen2-vl-2b-smoke patches", "qwen2-vl-2b", None, True, False),
    ("xlstm-350m-smoke int8 moments + wire", "xlstm-350m", None, False,
     True))
# two chunks of the recurrent smoke configs' 32; qwen2-vl: an 8 x 8 patch
# grid, then 16 text positions
TRAIN2_SMOKE_SEQ = {"qwen2-vl-2b": 80}
# held against the CPU by blocks in lockstep: a float32 step's grad norm
# parts by up to ~2e-5 between two devices from the same state (jamba's
# MoE layers carry its residual at ~50; the xLSTM's stabilizers take
# maxima, and with the int8 wire its raw gradients' norm parted by
# 1.3e-5)
TRAIN2_LOCKSTEP = {"jamba-v0.1-52b", "xlstm-350m"}
# xlstm's step is ~3 s (the sLSTM's time loop, host-bound): 4 steps in
# arm 1 (timed from step 2, the profiler on step 4), 3 in arm 2, one
# instrumented step each
TRAIN2_XLSTM = TrainSpec(tag="[train2]", steps=4, warmup=2, lr=1e-3,
                         timed_from=1, profiled=(3, 4), instrumented=1)
TRAIN2_FRONTEND = TrainSpec(tag="[train2]", steps=8, warmup=2, lr=1e-3,
                            timed_from=2, profiled=(3, 4), instrumented=1,
                            embeds=True)
TRAIN2_TRAFFIC = dict(n=8, lo=40, hi=96, max_new=12)
TRAIN2_BUDGET_S = 60


def host_copy(tree):
    """A nested tree of tensors copied to the host (on the CPU, ``.to``
    shares the live storage that the next step updates in place)."""
    if isinstance(tree, dict):
        return {k: host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [host_copy(v) for v in tree]
    return None if tree is None else tree.detach().cpu().clone()


class BlockTap:
    """Wraps ``models.transformer.block_apply`` for a train step: keeps
    each block's positions, input and output (host copies) and, through
    hooks, the gradients that reach its input and its output."""

    def __init__(self, fn):
        self.fn, self.rows = fn, []

    def __call__(self, blk, x, positions, **kw):
        row = {"pos": positions.cpu().clone(), "x": host_copy(x)}
        self.rows.append(row)

        def keep(key):
            return lambda g: row.__setitem__(key, host_copy(g))
        if x.requires_grad:
            x.register_hook(keep("gx"))
        y, cache, aux = self.fn(blk, x, positions, **kw)
        row["y"] = host_copy(y)
        y.register_hook(keep("gy"))
        return y, cache, aux


def lockstep_errors(model, cfg, rows, batch, grads, lb_coeff) -> float:
    """One train step's gradients by blocks in lockstep against another
    device's (``rows`` of its :class:`BlockTap`, ``grads`` its raw
    gradients): the embedding, each block and the head run here on that
    device's input and output gradient (a MoE block's lb loss at
    ``lb_coeff``); returns the largest error over every parameter's
    gradient, every block's output and every input gradient, each as a
    share of its leaf's largest magnitude."""
    import torch
    from repro_torch.models import transformer as ttr
    from repro_torch.models.common import cross_entropy, lm_head, rmsnorm

    def err(got, want):
        want = want.to(torch.float32)
        return float((got.detach().to(torch.float32) - want).abs().max()
                     / want.abs().max().clamp(min=1e-30))

    worst = 0.0
    for p in model.parameters():
        p.grad = None
    with torch.enable_grad():
        xh = rows[-1]["y"].clone().requires_grad_(True)
        h = rmsnorm(model.final_norm, xh, cfg.norm_eps)
        cross_entropy(lm_head(model.head_weight(), h),
                      batch["labels"]).backward()
        worst = max(worst, err(xh.grad, rows[-1]["gy"]))
        for blk, row in zip(model.layers, rows):
            xi = row["x"].clone().requires_grad_(True)
            y, _, aux = ttr.block_apply(blk, xi, row["pos"], cfg=cfg,
                                        cache=None, cache_pos=None)
            obj = (y * row["gy"]).sum()
            if "moe_lb_loss" in aux:
                obj = obj + lb_coeff * aux["moe_lb_loss"]
            obj.backward()
            worst = max(worst, err(y, row["y"]), err(xi.grad, row["gx"]))
        e = model.embed_rows(batch["tokens"])
        (e * rows[0]["gx"]).sum().backward()
    for n, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        if grads[n] is not None:
            worst = max(worst, err(got, grads[n]))
        elif bool(got.any()):
            return float("inf")          # a gradient the card never had
    return worst


def smoke_train2(seed: int, device: str, replay=None) -> dict:
    """(a) on ``device``: ``TRAIN_SMOKE_STEPS`` ``make_train_step`` steps
    of each :data:`TRAIN2_SMOKE` case (float32 smoke configs) from the
    seed's weights made on the CPU, on the same host-made batches (4 x 64
    ``lm_batch`` tokens, or ``make_batch``'s stub-frontend batch). Per
    case and step: the loss, the grad norm (of the wire's output with the
    int8 wire), the raw gradients' norm, and with the wire the gradients
    it passed on. Without ``replay``, also each step's starting train
    state (``train_state_tree`` on the host) and, for a
    :data:`TRAIN2_LOCKSTEP` arch, each step's raw gradients and
    :class:`BlockTap` rows. With ``replay`` (such a record), each step
    starts from the given state, and a lockstep arch's step is also held
    by blocks against the given rows (:func:`lockstep_errors`)."""
    import torch
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          load_train_state, make_train_step,
                                          train_state_tree)
    from repro_torch.models import transformer as ttr
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.adamw import AdamWConfig, global_norm
    from repro_torch.optim.compress import CompressionConfig
    real_opt, real_wire = steps_mod.adamw_update, steps_mod.compress_gradients
    real_block = ttr.block_apply
    rec = {}

    def spy_opt(params, grads, *a, **kw):
        rec["grads"] = grads
        return real_opt(params, grads, *a, **kw)

    def spy_wire(grads, *a, **kw):
        rec["raw"] = grads
        return real_wire(grads, *a, **kw)

    def norm(grads):
        return float(global_norm([g for g in grads.values()
                                  if g is not None]))

    out = {"steps": {}, "wire": {}, "states": {}, "taps": {}, "lockstep": {}}
    steps_mod.adamw_update, steps_mod.compress_gradients = spy_opt, spy_wire
    try:
        for label, arch, mode, embeds, int8 in TRAIN2_SMOKE:
            cfg = get_smoke_config(arch)
            if mode:
                cfg = dataclasses.replace(cfg, moe_mode=mode)
            lock = arch in TRAIN2_LOCKSTEP
            data = train_batches(cfg, TrainSpec(
                batch=4, seq=TRAIN2_SMOKE_SEQ.get(arch, 64), embeds=embeds),
                seed)
            hp = TrainHParams(
                lr=1e-3, adamw=AdamWConfig(quantize_moments=int8),
                grad_compress=CompressionConfig() if int8 else None)
            model = init_model(cfg, seed=seed, device="cpu", trainable=True)
            state = init_train_state(cfg, hp, model=model.to(device))
            step = make_train_step(cfg, hp)
            res, wire, starts, taps, errs = [], [], [], [], []
            for i in range(TRAIN_SMOKE_STEPS):
                batch = {k: v.to(device) for k, v in data(i).items()}
                if replay is not None:
                    load_train_state(state, replay["states"][label][i], cfg)
                    if lock:
                        t = replay["taps"][label][i]
                        errs.append(lockstep_errors(
                            state["params"], cfg, t["rows"], batch,
                            t["grads"], hp.lb_coeff))
                else:
                    starts.append(host_copy(train_state_tree(
                        state, cfg, device="cpu")))
                tap = BlockTap(real_block) if lock and replay is None \
                    else None
                rec.clear()
                ttr.block_apply = tap or real_block
                try:
                    state, m = step(state, batch)
                finally:
                    ttr.block_apply = real_block
                raw = rec.get("raw", rec["grads"])
                res.append((float(m["loss"]), float(m["grad_norm"]),
                            norm(raw)))
                if int8:
                    wire.append(host_copy(rec["grads"]))
                if tap is not None:
                    taps.append({"rows": tap.rows, "grads": host_copy(raw)})
            out["steps"][label] = res
            out["wire"][label] = wire
            out["states"][label] = starts
            out["taps"][label] = taps
            out["lockstep"][label] = errs
            del model, state
    finally:
        steps_mod.adamw_update = real_opt
        steps_mod.compress_gradients = real_wire
    if device != "cpu":
        torch.cuda.synchronize()
    return out


def cpu_smoke_train2(seed: int, src: str, replay_path: str = "") -> dict:
    """:func:`smoke_train2` on the CPU, in a child process, one thread:
    free-running, or replaying the card's record saved (``torch.save``)
    at ``replay_path``."""
    sys.path.insert(0, src)
    import torch
    torch.set_num_threads(1)
    replay = torch.load(replay_path) if replay_path else None
    out = smoke_train2(seed, "cpu", replay)
    return {k: out[k] for k in ("steps", "wire", "lockstep")}


def wire_flips(card, cpu, groups) -> tuple:
    """The int8 wire's output on two devices from the same state: values
    one grid step apart (the group's absmax over 127, at a rounding tie
    where the raw gradients differ by float ULPs) and the values
    compared; raises on any other difference."""
    flips = total = 0
    by_name = {n: g for g in groups for n in g}
    for n, want in cpu.items():
        scale = max(float(cpu[m].abs().max())
                    for m in by_name.get(n, (n,))) / 127
        # scales that differ by ULPs move every value a little; a value
        # that moved half a step or more crossed a tie
        d = (card[n] - want).abs()
        moved = d > 0.5 * scale
        if bool((d[moved] > 1.001 * scale).any()):
            raise AssertionError(f"[train2] (a) the wire's output of {n} "
                                 f"differs by more than one grid step")
        flips += int(moved.sum())
        total += d.numel()
    return flips, total


def train2_card_vs_cpu(card: dict, cpu_free, cpu_replay) -> dict:
    """(a): every :data:`TRAIN2_SMOKE` case trained on the card (TF32 off)
    against the CPU, each step the CPU takes from the card's own starting
    state (the weights, moments and residual the card held before it):
    the loss within rtol 1e-5; the grad norm too, but for a
    :data:`TRAIN2_LOCKSTEP` arch its gradients by blocks in lockstep, each
    within 1e-4 of its leaf's largest magnitude (as the CPU tests hold
    jamba: ROADMAP's parity traps); with the int8 wire, its output equal
    but for counted one-step flips at rounding ties (at most 0.1%). The
    free-running CPU
    steps (from the same start, each package on its own state after) are
    printed beside them: step 1 is the same step, and later steps part as
    Adam turns gradients that differ by float ULPs into whole steps."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.steps import reference_groups
    from repro_torch.models.transformer import Transformer
    free, replay = cpu_free.result(), cpu_replay.result()

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    worst, failed = {}, []
    for label, arch, _, _, int8 in TRAIN2_SMOKE:
        mine, theirs = card["steps"][label], replay["steps"][label]
        loss = max(rel(a[0], b[0]) for a, b in zip(mine, theirs))
        gnorm = max(rel(a[1], b[1]) for a, b in zip(mine, theirs))
        raw = max(rel(a[2], b[2]) for a, b in zip(mine, theirs))
        drift = [max(rel(a[0], b[0]), rel(a[1], b[1]))
                 for a, b in zip(mine, free["steps"][label])]
        rec = {"loss": loss, "grad_norm": gnorm, "raw_grad_norm": raw,
               "free_running": drift}
        ok = loss <= 1e-5
        extra = ""
        if arch in TRAIN2_LOCKSTEP:
            lock = max(replay["lockstep"][label])
            rec["lockstep"] = lock
            ok = ok and lock <= 1e-4
            extra = f"; by blocks in lockstep: largest error {lock:.2e} of " \
                    f"a leaf's largest magnitude (limit 1e-4)"
        else:
            ok = ok and gnorm <= 1e-5
        if int8:
            cfg = get_smoke_config(arch)
            groups = reference_groups(Transformer(cfg, "meta"), cfg)
            flips = total = 0
            for a, b in zip(card["wire"][label], replay["wire"][label]):
                f, n = wire_flips(a, b, groups)
                flips, total = flips + f, total + n
            rec["wire_flips"] = (flips, total)
            ok = ok and flips <= 1e-3 * total
            extra += f"; the wire's output: {flips} of {total} values one " \
                     f"grid step apart (limit 0.1%)"
        worst[label] = rec
        if not ok:
            failed.append(label)
        (l1, g1, _), (l5, g5, _) = mine[0], mine[-1]
        print(f"[train2] (a) {label}: {TRAIN_SMOKE_STEPS} steps, loss card "
              f"{l1:.7f} -> {l5:.7f}, grad norm {g1:.5f} -> {g5:.5f}; each "
              f"step on the CPU from the card's state, largest relative "
              f"difference: loss {loss:.2e} (limit 1e-5), raw gradients' "
              f"norm {raw:.2e}, grad norm {gnorm:.2e}"
              + ("" if arch in TRAIN2_LOCKSTEP else " (limit 1e-5)")
              + extra + "; free-running, by step: "
              + " ".join(f"{d:.1e}" for d in drift), flush=True)
    if failed:
        raise AssertionError(f"[train2] (a) card and CPU part past their "
                             f"limits: {failed}")
    return {"card": card["steps"], "cpu_free": free["steps"],
            "cpu_replay": replay["steps"], "worst": worst}


def train2_phase(seed: int):
    """``[train2]``: (a) the :data:`TRAIN2_SMOKE` cases trained on the
    card, then against the CPU (child processes, free-running and from
    the card's states, beside (b)-(d)); (b) xlstm-350m at its
    published widths and depth, two arms of :data:`TRAIN2_XLSTM` at 4 x
    512 ``lm_batch`` tokens (a state crosses one chunk boundary of 256):
    fp32 moments (profiled), and W10 / D12 / KV8 with int8 moments and the
    int8 wire (every block matrix's and every chunk boundary's step-1
    gradient nonzero, C5 and C8); (c) hubert-xlarge at its published
    widths and depth from stub frame embeddings (profiled); (d)
    qwen2-vl-2b at its published widths and depth from patch embeddings
    with M-RoPE ids, its trained weights then served through B1 at G = 6.
    Each model is freed before the next. Float32 matmuls without TF32
    (set by ``main``). Returns (B1 launches, records)."""
    import concurrent.futures
    import gc
    import multiprocessing
    import shutil
    import tempfile

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import build_quant
    from repro_torch.models.transformer import params_to_numpy

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    t_phase = time.perf_counter()
    free()
    print(card_line(), flush=True)
    print(f"[train2] card memory held before the phase: "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB", flush=True)
    src = str(Path(__file__).resolve().parent / "src")
    rehearsal = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    part_s, arms = {}, {}

    def describe(cfg, what):
        print(f"[train2] {cfg.name} at published widths and depth: "
              f"{cfg.num_layers} layers, d_model {cfg.d_model}, vocab "
              f"{cfg.vocab_size}, {cfg.dtype} compute over "
              f"{cfg.param_dtype} masters ({cfg.param_count():,} "
              f"parameters); {what}", flush=True)

    tmp = tempfile.mkdtemp()
    try:
        cpu_free = rehearsal.submit(cpu_smoke_train2, seed, src)
        t0 = time.perf_counter()
        card_a = smoke_train2(seed, "cuda")
        replay_path = str(Path(tmp) / "card.pt")
        torch.save({k: card_a.pop(k) for k in ("states", "taps")},
                   replay_path)
        cpu_replay = rehearsal.submit(cpu_smoke_train2, seed, src,
                                      replay_path)
        part_s["a_card"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg = get_config("xlstm-350m")
        sp = TRAIN2_XLSTM
        describe(cfg, f"{sp.steps} steps of {sp.batch} x {sp.seq} lm_batch "
                 f"tokens, chunk {cfg.ssm_chunk}, lr {sp.lr}, warm-up "
                 f"{sp.warmup}")
        arms["b1"], model = train_arm(cfg, "b1 fp32 moments", seed,
                                      int8=False, profile=True, spec=sp)
        del model
        free()
        quant = build_quant(cfg, weight_bits=10, data_bits=12, kv_bits=8,
                            policy_json="")
        arms["b2"], model = train_arm(
            cfg, "b2 W10/D12/KV8 int8 moments int8 wire", seed, quant=quant,
            int8=True, profile=False, spec=dataclasses.replace(sp, steps=3),
            state_grads=True)
        del model
        free()
        part_s["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg = get_config("hubert-xlarge")
        sp = TRAIN2_FRONTEND
        describe(cfg, f"{sp.steps} steps of {sp.batch} x {sp.seq} stub "
                 f"frame embeddings, unit labels over {cfg.vocab_size}")
        arms["c"], model = train_arm(cfg, "c hubert-xlarge frames", seed,
                                     int8=False, profile=True, spec=sp)
        del model
        free()
        part_s["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vcfg = get_config("qwen2-vl-2b")
        describe(vcfg, f"{sp.steps} steps of {sp.batch} x {sp.seq} stub "
                 f"patch embeddings with M-RoPE ids (make_batch)")
        arms["d"], model = train_arm(vcfg, "d qwen2-vl-2b patches", seed,
                                     int8=False, profile=False, spec=sp)
        tree = params_to_numpy(model, vcfg)
        del model
        free()
        part_s["d_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        card = train2_card_vs_cpu(card_a, cpu_free, cpu_replay)
        part_s["a_wait"] = time.perf_counter() - t0
    finally:
        rehearsal.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    launches, serve = train_serve_check(vcfg, tree, seed, tag="[train2]",
                                        arch=vcfg.name,
                                        traffic=TRAIN2_TRAFFIC)
    del tree
    part_s["d_serve"] = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    print(f"[train2] main path: {launches} B1 launches = layers x programs "
          f"over the kernel runs of (d); phase {wall:.1f} s against a "
          f"{TRAIN2_BUDGET_S} s budget (" + ", ".join(
              f"({k}) {v:.1f}" for k, v in part_s.items()) + " s)",
          flush=True)
    record = {"phase": "train2", "arms": arms, "card_vs_cpu": card,
              "serve": serve, "b1_launches": launches, "phase_s": wall,
              "part_s": part_s, "budget_s": TRAIN2_BUDGET_S}
    return launches, [record]


# ---------------------------------------------------------------------------
# [dist]: distributed training on a one-rank NCCL group
# ---------------------------------------------------------------------------
DIST_LAYERS = 2          # deepseek-7b's 30 cut: two ~15 GB states side by side
DIST_STEPS = 5
DIST_SMOKE_STEPS = 3
DIST_CLI_STEPS = 6
DIST_BUDGET_S = 45


def dist_state_leaves(state):
    """Every leaf of a train state (masters, moments' grids and scales or
    float32 moments, residuals, the step) as {key: tensor}."""
    out = {f"params/{n}": p.detach()
           for n, p in state["params"].named_parameters()}
    out["opt/step"] = state["opt"]["step"]
    for k in ("m", "v"):
        for n, v in state["opt"][k].items():
            if isinstance(v, dict):
                out.update({f"opt/{k}/{n}/{j}": x for j, x in v.items()})
            else:
                out[f"opt/{k}/{n}"] = v
    for n, r in state.get("ef_residual", {}).items():
        out[f"ef_residual/{n}"] = r
    return out


def dist_arm(cfg, label: str, seed: int, plan, *, quantized: bool) -> dict:
    """(a) / (b): ``DIST_STEPS`` steps of 4 x 512 ``lm_batch`` tokens
    through ``make_train_step(plan=)`` and through the plain step, each
    from its own copy of one seeded state: losses, grad norms and every
    state leaf compared bit for bit; each step timed alone (a device
    sync, then CUDA events: :class:`SyncTimer`); peak memory."""
    import gc

    import torch
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          make_train_step, shard_train_state)
    from repro_torch.launch.train import build_quant
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compress import CompressionConfig
    hp = TrainHParams(lr=TRAIN_LR, adamw=AdamWConfig(
        quantize_moments=quantized),
        grad_compress=CompressionConfig() if quantized else None)
    quant = (build_quant(cfg, weight_bits=10, data_bits=12, kv_bits=8,
                         policy_json="") if quantized else None)
    dcfg = train_data(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed)
    batches = [{k: v.to("cuda") for k, v in lm_batch(dcfg, s).items()}
               for s in range(DIST_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    plain = init_train_state(cfg, hp, seed=seed, device="cuda")
    mesh = shard_train_state(init_train_state(cfg, hp, seed=seed,
                                              device="cuda"), cfg, plan)
    before = dist_state_leaves(mesh)
    same_start = all(torch.equal(x, before[k])
                     for k, x in dist_state_leaves(plain).items())
    del before
    runs = {}
    for name, state, p in (("plain", plain, None), ("mesh", mesh, plan)):
        step = SyncTimer(make_train_step(cfg, hp, quant=quant, plan=p))
        metrics = []
        for b in batches:
            _, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        runs[name] = {"metrics": metrics, "ms": step.ms()}
    a, b = dist_state_leaves(plain), dist_state_leaves(mesh)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ok = (same_start and not differ
          and runs["mesh"]["metrics"] == runs["plain"]["metrics"])
    print(f"[dist] ({'b' if quantized else 'a'}) {label}: {DIST_STEPS} steps "
          f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, mesh vs plain: losses "
          f"{[m[0] for m in runs['mesh']['metrics']]} vs "
          f"{[m[0] for m in runs['plain']['metrics']]}, grad norms "
          f"{[m[1] for m in runs['mesh']['metrics']]} vs "
          f"{[m[1] for m in runs['plain']['metrics']]}; {len(a)} state "
          f"leaves, {len(differ)} differ {differ[:4]}; step ms mesh "
          f"{runs['mesh']['ms']:.2f} plain {runs['plain']['ms']:.2f} "
          f"(median, CUDA events after a sync); peak {peak:.2f} GiB",
          flush=True)
    leaves = len(a)
    del plain, mesh, a, b, batches
    gc.collect()
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"[dist] {label}: the mesh step is not the "
                             f"plain step bit for bit")
    return {"label": label, "quantized": quantized, "leaves": leaves,
            "mesh": runs["mesh"], "plain": runs["plain"], "peak_gib": peak}


def dist_elastic(seed: int, mesh, plan) -> dict:
    """(c): deepseek-7b-smoke trained ``DIST_SMOKE_STEPS`` steps through the
    mesh step, its checkpoint written under the plan (each leaf gathered,
    rank 0 writing), then ``elastic_restore`` onto a plain state from
    another seed: every leaf bit for bit; one more step of each (the
    mesh step on the trained state, the plain step on the restored one)
    equal bit for bit."""
    import tempfile

    import torch
    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch.steps import (TrainHParams, init_train_state,
                                          make_train_step, shard_train_state,
                                          train_state_tree)
    from repro_torch.runtime import elastic_restore
    cfg = get_smoke_config(TRAIN_ARCH)
    hp = TrainHParams(lr=1e-3)
    dcfg = train_data(cfg, batch=4, seq=64, seed=seed)
    state = shard_train_state(init_train_state(cfg, hp, seed=seed,
                                               device="cuda"), cfg, plan)
    step = make_train_step(cfg, hp, plan=plan)
    for s in range(DIST_SMOKE_STEPS):
        step(state, {k: v.to("cuda") for k, v in lm_batch(dcfg, s).items()})
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, DIST_SMOKE_STEPS, train_state_tree(
            state, cfg, plan=plan), extra={"data": {"step": 3}}, plan=plan)
        got, restored, extra = elastic_restore(
            d, init_train_state(cfg, hp, seed=seed + 1, device="cuda"), mesh)
    a, b = dist_state_leaves(state), dist_state_leaves(restored)
    differ = [k for k in a if not torch.equal(a[k], b[k].to(a[k].device))]
    nxt = {k: v.to("cuda") for k, v in lm_batch(dcfg, 3).items()}
    _, m_mesh = step(state, nxt)
    _, m_plain = make_train_step(cfg, hp)(restored, nxt)
    same = all(torch.equal(m_mesh[k], m_plain[k]) for k in m_mesh)
    print(f"[dist] (c) {TRAIN_ARCH}-smoke: checkpoint of step {got} "
          f"(extra {extra}) elastic_restore'd onto a plain state: "
          f"{len(a)} leaves, {len(differ)} differ; the next step mesh vs "
          f"plain: loss {float(m_mesh['loss'])} vs "
          f"{float(m_plain['loss'])}, bitwise {same}", flush=True)
    if got != DIST_SMOKE_STEPS or differ or not same:
        raise AssertionError("[dist] (c): the elastic round trip is not "
                             "bit for bit")
    return {"leaves": len(a), "differ": len(differ), "next_bitwise": same}


def dist_cli(seed: int) -> dict:
    """(d): ``python -m torch.distributed.run --nproc-per-node 1 -m
    repro_torch.launch.train`` (a child process, the launcher's group
    joined through ``env://``) against the plain CLI in this process (on
    the phase's group): losses within rtol 1e-5."""
    import json as _json
    import tempfile

    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import free_port
    args = ["--arch", TRAIN_ARCH, "--smoke", "--mesh", "host", "--steps",
            str(DIST_CLI_STEPS), "--batch-size", "4", "--seq-len", "64",
            "--lr", "1e-3", "--warmup", "2", "--log-every", "1",
            "--seed", str(seed)]
    src = str(Path(__file__).resolve().parent / "src")
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "m.json")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "1", "--master-port", str(free_port()),
             "-m", "repro_torch.launch.train"] + args
            + ["--metrics-out", out], capture_output=True, text=True,
            timeout=300, env=dict(os.environ, PYTHONPATH=src))
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise RuntimeError(f"[dist] (d) torch.distributed.run failed:\n"
                               f"{child.stderr[-3000:]}")
        launched = _json.loads(Path(out).read_text())
    plain = train_mod.main(args)
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
              for a, b in zip(launched, plain))
    ok = (len(launched) == len(plain) == DIST_CLI_STEPS and rel <= 1e-5)
    print(f"[dist] (d) torch.distributed.run --nproc-per-node 1 ... "
          f"--mesh host ({child_s:.1f} s, a child process): losses "
          f"{[r['loss'] for r in launched]} vs the plain CLI's "
          f"{[r['loss'] for r in plain]}: max rel diff {rel:.3g} (rtol "
          f"1e-5)", flush=True)
    if not ok:
        raise AssertionError("[dist] (d): the launched CLI parts from the "
                             "plain CLI")
    return {"max_rel": rel, "child_s": child_s}


def dist_world_one(plan) -> dict:
    """(e): ``quantized_allreduce`` over the one-rank "data" axis returns
    its CUDA input; ``gpipe_apply`` on a one-stage mesh equals the
    sequential chain, forward and gradient."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim.compress import quantized_allreduce
    from repro_torch.parallel.hints import activation_hints
    from repro_torch.parallel.pipeline import gpipe_apply
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4096, generator=g).to("cuda")
    with activation_hints(plan):
        ring = quantized_allreduce(x, "data") is x
    stage = make_test_mesh((1,), ("stage",), device="cuda")
    W = (torch.randn(1, 64, 64, generator=g) * 0.3).to("cuda")
    xs = torch.randn(4, 2, 64, generator=g).to("cuda")
    got_w = W.clone().requires_grad_(True)
    got = gpipe_apply(lambda w, h: torch.tanh(h @ w), got_w, xs, mesh=stage)
    got.sum().backward()
    want_w = W.clone().requires_grad_(True)
    want = torch.tanh(xs @ want_w[0])
    want.sum().backward()
    fwd = float((got - want).detach().abs().max())
    bwd = float((got_w.grad - want_w.grad).abs().max())
    print(f"[dist] (e) world size 1 on CUDA tensors: quantized_allreduce "
          f"returns its input {ring}; gpipe_apply S = 1, M = 4 vs the "
          f"chain: forward {fwd:.3g}, weight gradient {bwd:.3g}",
          flush=True)
    if not ring or fwd > 1e-6 or bwd > 1e-5:
        raise AssertionError("[dist] (e) failed")
    return {"ring_identity": ring, "gpipe_fwd": fwd, "gpipe_bwd": bwd}


def dist_phase(seed: int) -> dict:
    """``[dist]``: the sharded trainer on a one-rank NCCL group
    (``make_host_mesh("cuda")``, ``plan_for_mesh``): (a) deepseek-7b at
    published widths cut to ``DIST_LAYERS`` layers, ``DIST_STEPS`` steps of
    4 x 512 ``lm_batch`` tokens through ``make_train_step(plan=)`` against
    the plain step from the same state, fp32 moments: losses, grad norms
    and every state leaf bit for bit; (b) the same with W10 / D12 / KV8,
    int8 moments and the int8 wire; (c) the elastic round trip on
    deepseek-7b-smoke; (d) the CLI under ``torch.distributed.run`` against
    the plain CLI; (e) ``quantized_allreduce`` and ``gpipe_apply`` at world
    size 1 on CUDA tensors. Step ms by CUDA events, peak memory, the
    phase's seconds against ``DIST_BUDGET_S``. No kernel of the port is on
    this path (a training forward reaches no B1-B6). Returns the record."""
    import dataclasses as dc
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import close_process_group, make_host_mesh
    from repro_torch.parallel.sharding import plan_for_mesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    opened = not dist.is_initialized()
    mesh = make_host_mesh("cuda")
    try:
        plan = plan_for_mesh(mesh)
        print(f"[dist] host mesh {tuple(mesh.shape)} "
              f"{mesh.mesh_dim_names} on {dist.get_backend()}, world "
              f"{dist.get_world_size()}", flush=True)
        cfg = dc.replace(get_config(TRAIN_ARCH), num_layers=DIST_LAYERS)
        print(f"[dist] {TRAIN_ARCH} at published widths cut to "
              f"{cfg.num_layers} of 30 layers ({cfg.param_count():,} "
              f"parameters)", flush=True)
        part_s = {}
        t0 = time.perf_counter()
        arm_a = dist_arm(cfg, "fp32 moments", seed, plan, quantized=False)
        part_s["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        arm_b = dist_arm(cfg, "W10/D12/KV8 int8 moments int8 wire", seed,
                         plan, quantized=True)
        part_s["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        elastic = dist_elastic(seed, mesh, plan)
        part_s["c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli = dist_cli(seed)
        part_s["d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        world_one = dist_world_one(plan)
        part_s["e"] = time.perf_counter() - t0
    finally:
        if opened:
            close_process_group()
    wall = time.perf_counter() - t_phase
    print(f"[dist] phase {wall:.1f} s against a {DIST_BUDGET_S} s budget "
          f"((a) {part_s['a']:.1f}, (b) {part_s['b']:.1f}, (c) "
          f"{part_s['c']:.1f}, (d) {part_s['d']:.1f}, (e) "
          f"{part_s['e']:.1f} s)", flush=True)
    return {"phase": "dist", "layers": DIST_LAYERS, "arms": [arm_a, arm_b],
            "elastic": elastic, "cli": cli, "world_one": world_one,
            "phase_s": wall, "part_s": part_s, "budget_s": DIST_BUDGET_S}


# ---------------------------------------------------------------------------
# [ep]: expert parallelism on a one-rank NCCL mesh with a model axis: one
# deepseek-v3 MoE layer's dispatch, and jamba-v0.1 trained through the
# expert-parallel step
# ---------------------------------------------------------------------------
EP_TOKENS = (4, 512)          # (a): one train step's rows of deepseek-v3
EP_BITS = (0, 8, 16)
EP_TRAIN_LAYERS = 2           # jamba-v0.1's 32 cut: ~37 GB of state an arm
EP_TRAIN_STEPS = 3
EP_BUDGET_S = 45


@functools.lru_cache(maxsize=None)
def _wire_ste():
    """The wire's quantize-dequantize with the identity's gradient (an
    autograd Function): the plain version of the expert-parallel
    dispatch's wire at one rank."""
    import torch
    from repro_torch.parallel.hints import wire_round_trip

    class WireSTE(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t, bits):
            return wire_round_trip(t, bits)

        @staticmethod
        def backward(ctx, g):
            return g, None

    return WireSTE


def plain_dispatch(p, x, cfg):
    """The MoE forward with the plain local dispatch (the capacity of all
    of x's tokens), the wire's quantize-dequantize applied where the
    expert-parallel dispatch sends and receives (``cfg.moe_a2a_bits``)."""
    from repro_torch.models import moe
    from repro_torch.models.mlp import swiglu_apply
    B, S, D = x.shape
    T, k, bits = B * S, cfg.experts_per_token, cfg.moe_a2a_bits
    w, idx, _ = moe._route(p, x, cfg)
    buf, e_a, pos_s, keep = moe._dispatch(x.reshape(T, D), idx.reshape(T, k),
                                          cfg)
    if bits:
        buf = _wire_ste().apply(buf, bits)
    y = moe._experts_ffn(p, buf)
    if bits:
        y = _wire_ste().apply(y, bits)
    out = moe._combine(y, e_a, pos_s, keep, w.reshape(T, k)).reshape(B, S, D)
    return out + swiglu_apply(p.shared, x)


def ep_dispatch(seed: int, plan) -> dict:
    """(a): one MoE layer of deepseek-v3 at published widths (256 experts
    of F 2048 top-8, D 7168, a shared expert, sigmoid router), scatter,
    bf16, on ``EP_TOKENS`` rows: ``moe_apply`` forward and backward under
    the train step's mark against :func:`plain_dispatch`, at each wire
    width: the output and every gradient (experts, router, shared expert,
    x) bit for bit; ms of each (CUDA events after a sync) and peak memory.
    Then the wire on the NCCL model group itself (at one rank the dispatch
    skips the exchange): ``wire_all_to_all`` of a (256, C, 7168) buffer
    against its round trip, and what crossed the group."""
    import types

    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe
    from repro_torch.parallel import hints
    cfg = dataclasses.replace(get_config(DSV3), moe_mode="scatter")
    D, E, F = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    B, S = EP_TOKENS
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    mod = moe.MoE(cfg, torch.bfloat16, device="cuda")
    moe.init_moe(mod, g)
    leaves = {"router": mod.router, "w_gate": mod.w_gate, "w_up": mod.w_up,
              "w_down": mod.w_down, "shared.w_gate": mod.shared.w_gate,
              "shared.w_up": mod.shared.w_up,
              "shared.w_down": mod.shared.w_down}
    leaves = {n: t.detach().requires_grad_(True) for n, t in leaves.items()}
    p = types.SimpleNamespace(
        shared=types.SimpleNamespace(
            **{n[7:]: t for n, t in leaves.items() if n.startswith("shared")}),
        **{n: t for n, t in leaves.items() if "." not in n})
    x = torch.randn(B, S, D, generator=g, device="cuda", dtype=torch.bfloat16)
    cot = torch.randn(B, S, D, generator=g, device="cuda",
                      dtype=torch.bfloat16)
    C = max(1, int(np.ceil(B * S * cfg.experts_per_token / E
                           * cfg.moe_capacity_factor)))
    expert_gib = sum(leaves[n].numel() * 2 for n in ("w_gate", "w_up",
                                                     "w_down")) / 2 ** 30
    print(f"[ep] (a) {DSV3} MoE layer at published widths: {E} experts of "
          f"F {F} top-{cfg.experts_per_token} sigmoid + "
          f"{cfg.num_shared_experts} shared, D {D}, bf16; {B} x {S} tokens, "
          f"capacity C = {C}; the experts {expert_gib:.2f} GiB (and their "
          f"gradients as much)", flush=True)

    def arm(mesh: bool, bits: int):
        c = dataclasses.replace(cfg, moe_a2a_bits=bits)
        for t in leaves.values():
            t.grad = None
        xg = x.detach().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        if mesh:
            with hints.train_step_mark(plan, ("data",)):
                y, _ = moe.moe_apply(p, xg, cfg=c)
        else:
            y = plain_dispatch(p, xg, c)
        y.backward(cot)
        e.record()
        torch.cuda.synchronize()
        grads = {n: t.grad for n, t in leaves.items()}
        grads["x"] = xg.grad
        for t in leaves.values():
            t.grad = None
        return (y.detach(), grads, s.elapsed_time(e),
                torch.cuda.max_memory_allocated() / 2 ** 30)

    for bits in (0, 8):         # untimed: the card's first launches
        arm(True, bits)
        arm(False, bits)
    out = {}
    for bits in EP_BITS:
        ym, gm, ms_m, peak_m = arm(True, bits)
        yp, gp, ms_p, peak_p = arm(False, bits)
        differ = [n for n in gm if not torch.equal(gm[n], gp[n])]
        same = torch.equal(ym, yp) and not differ
        out[bits] = {"bitwise": same, "differ": differ, "mesh_ms": ms_m,
                     "plain_ms": ms_p, "mesh_peak_gib": peak_m,
                     "plain_peak_gib": peak_p,
                     "finite": bool(torch.isfinite(ym).all())}
        del ym, gm, yp, gp
        print(f"[ep] (a) {bits or 'no'} wire{' bits' if bits else ''}: "
              f"moe_apply under the mark vs the plain dispatch"
              f"{' with the wire round trip at its two points' if bits else ''}"
              f": output and {len(leaves) + 1} gradients bit for bit {same} "
              f"{differ}; forward + backward {ms_m:.2f} ms (plain "
              f"{ms_p:.2f}), peak {peak_m:.2f} GiB (plain {peak_p:.2f})",
              flush=True)
    # the wire on the NCCL model group
    group = plan.mesh.get_group(plan.model_axis)
    buf = torch.randn(1, E, C, D, generator=g, device="cuda",
                      dtype=torch.bfloat16)
    seen = {"payload": [], "sent": []}
    orig_x, orig_a = hints._exchange, dist.all_to_all_single

    def exchange(t, grp):
        seen["payload"].append(str(t.dtype).replace("torch.", ""))
        return orig_x(t, grp)

    def send(o, i, *a, **kw):
        seen["sent"].append(str(i.dtype).replace("torch.", ""))
        return orig_a(o, i, *a, **kw)

    hints.all_to_all(buf, group)      # untimed: NCCL's first call
    hints._exchange, dist.all_to_all_single = exchange, send
    wire = {}
    try:
        for bits in EP_BITS:
            seen["payload"].clear()
            seen["sent"].clear()
            torch.cuda.synchronize()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            got = (hints.wire_all_to_all(buf, group, bits) if bits
                   else hints.all_to_all(buf, group))
            e.record()
            torch.cuda.synchronize()
            want = hints.wire_round_trip(buf, bits) if bits else buf
            wire[bits] = {"equal": torch.equal(got, want),
                          "payload": list(seen["payload"]),
                          "sent": list(seen["sent"]),
                          "ms": s.elapsed_time(e)}
    finally:
        hints._exchange, dist.all_to_all_single = orig_x, orig_a
    print(f"[ep] (a) the exchange of a ({E}, {C}, {D}) buffer on the "
          f"{dist.get_backend(group)} model group ({dist.get_world_size(group)} "
          f"rank): " + "; ".join(
              f"{b or 'no'} wire{' bits' if b else ''}: payload "
              f"{w['payload']} sent as {w['sent']}, {w['ms']:.3f} ms, equal "
              f"to its round trip {w['equal']}" for b, w in wire.items()),
          flush=True)
    del leaves, p, mod, x, cot, buf
    bad = [b for b, r in out.items() if not (r["bitwise"] and r["finite"])]
    want_payload = {0: ["bfloat16"], 8: ["int8", "float32"],
                    16: ["int16", "float32"]}
    bad += [f"wire {b}" for b, w in wire.items()
            if not w["equal"] or w["payload"] != want_payload[b]]
    if bad:
        raise AssertionError(f"[ep] (a) failed: {bad}")
    return {"arms": out, "wire": wire, "capacity": C,
            "experts_gib": expert_gib}


def leaf_checksum(t, chunk: int = 1 << 26) -> tuple:
    """(sum, position-weighted sum) of a tensor's bytes read as integers
    of its element size, int64 arithmetic (wrapping), chunk by chunk."""
    import torch
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    v = t.detach().contiguous().reshape(-1).view(ints[t.element_size()])
    s0 = torch.zeros((), dtype=torch.int64, device=v.device)
    s1 = torch.zeros((), dtype=torch.int64, device=v.device)
    pos = (torch.arange(min(chunk, v.numel()), device=v.device) % 65521) + 1
    for i in range(0, v.numel(), chunk):
        c = v[i:i + chunk].to(torch.int64)
        s0 += c.sum()
        s1 += (c * pos[:c.numel()]).sum() * (i // chunk + 1)
    return int(s0), int(s1)


def ep_train(seed: int, plan) -> dict:
    """(b): jamba-v0.1 at published widths cut to ``EP_TRAIN_LAYERS``
    layers (Mamba + MLP, Mamba + 16 experts top-2), scatter, int8
    moments, ``EP_TRAIN_STEPS`` steps of 4 x 512 ``lm_batch`` tokens in
    three arms one after another, each from the same seeded state: the
    plain step; ``make_train_step(plan=)`` (expert-parallel, the experts
    E / 1); the same at ``moe_a2a_bits`` 8. The first two bit for bit in
    losses, grad norms and a checksum of every state leaf's bytes; the
    wired arm's losses finite and its first gradient nonzero on every
    expert of every stack (straight-through: C10). Step ms (CUDA events
    after a sync) and peak memory per arm."""
    import gc

    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch.steps import (TrainHParams, _expert_leaves,
                                          init_train_state, loss_and_grads,
                                          make_train_step, shard_train_state,
                                          train_state_specs)
    from repro_torch.optim.adamw import AdamWConfig
    full = get_config(JAMBA)
    cfg = dataclasses.replace(full, num_layers=EP_TRAIN_LAYERS,
                              moe_mode="scatter")
    hp = TrainHParams(lr=TRAIN_LR, adamw=AdamWConfig(quantize_moments=True))
    dcfg = train_data(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed)
    batches = [{k: v.to("cuda") for k, v in lm_batch(dcfg, s).items()}
               for s in range(EP_TRAIN_STEPS)]
    print(f"[ep] (b) {JAMBA} at published widths cut to {cfg.num_layers} of "
          f"{full.num_layers} layers ({cfg.param_count():,} parameters; "
          f"layer 1: Mamba + {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}), scatter, int8 moments, "
          f"{EP_TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens",
          flush=True)
    arms = {}
    for label, p, bits in (("plain", None, 0), ("mesh", plan, 0),
                           ("mesh, 8-bit wire", plan, 8)):
        c = dataclasses.replace(cfg, moe_a2a_bits=bits)
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(c, hp, seed=seed, device="cuda")
        if p is not None:
            shard_train_state(state, c, p)
        reached = None
        if bits:
            specs = train_state_specs(state, c, p)["params"]
            _, grads = loss_and_grads(state["params"], batches[0], c,
                                      plan=p, specs=specs)
            names = sorted(_expert_leaves(state["params"]))
            reached = {n: int((grads[n].flatten(1).abs().amax(1) > 0).sum())
                       for n in names}
            del grads
        step = SyncTimer(make_train_step(c, hp, plan=p))
        metrics = []
        for b in batches:
            m = step(state, b)[1]      # (the state is updated in place)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        sums = {k: leaf_checksum(v)
                for k, v in dist_state_leaves(state).items()}
        arms[label] = {"metrics": metrics, "ms": step.ms(),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "sums": sums, "experts_reached": reached}
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[ep] (b) {label}: losses {[m[0] for m in metrics]}, grad "
              f"norms {[m[1] for m in metrics]}; step ms "
              f"{arms[label]['ms']:.2f} (median, CUDA events after a sync), "
              f"peak {arms[label]['peak_gib']:.2f} GiB"
              + (f"; step 1's gradient nonzero on {reached} of "
                 f"{cfg.num_experts} experts a stack" if reached else ""),
              flush=True)
    a, b = arms["plain"], arms["mesh"]
    differ = [k for k in a["sums"] if a["sums"][k] != b["sums"][k]]
    wired = arms["mesh, 8-bit wire"]
    print(f"[ep] (b) mesh vs plain: losses and grad norms equal "
          f"{a['metrics'] == b['metrics']}, {len(a['sums'])} state leaves, "
          f"{len(differ)} checksums differ {differ[:4]}; the wired arm's "
          f"losses differ from the plain's by "
          f"{[w[0] - p[0] for w, p in zip(wired['metrics'], a['metrics'])]}",
          flush=True)
    ok = (a["metrics"] == b["metrics"] and not differ
          and all(np.isfinite(m[0]) for m in wired["metrics"])
          and all(n == cfg.num_experts
                  for n in wired["experts_reached"].values()))
    leaves = len(a["sums"])
    for r in arms.values():
        del r["sums"]
    if not ok:
        raise AssertionError("[ep] (b) failed")
    return {"arms": arms, "leaves": leaves, "differ": len(differ),
            "params": cfg.param_count()}


def ep_phase(seed: int) -> dict:
    """``[ep]``: expert parallelism on a one-rank NCCL group whose mesh
    has a model axis (``make_test_mesh((1, 1), ("data", "model"))``): (a)
    :func:`ep_dispatch`, (b) :func:`ep_train`. No kernel of the port is on
    this path (a training forward reaches none of B1-B6). The phase's
    seconds against ``EP_BUDGET_S``. Returns the record."""
    import gc

    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import close_process_group, make_test_mesh
    from repro_torch.parallel.sharding import plan_for_mesh

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    opened = not dist.is_initialized()
    mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
    try:
        plan = plan_for_mesh(mesh)
        print(f"[ep] mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} on "
              f"{dist.get_backend()}, world {dist.get_world_size()}",
              flush=True)
        part_s = {}
        t0 = time.perf_counter()
        dispatch = ep_dispatch(seed, plan)
        gc.collect()
        torch.cuda.empty_cache()
        part_s["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train = ep_train(seed, plan)
        part_s["b"] = time.perf_counter() - t0
    finally:
        if opened:
            close_process_group()
    wall = time.perf_counter() - t_phase
    print(f"[ep] phase {wall:.1f} s against a {EP_BUDGET_S} s budget ((a) "
          f"{part_s['a']:.1f}, (b) {part_s['b']:.1f} s)", flush=True)
    return {"phase": "ep", "dispatch": dispatch, "train": train,
            "phase_s": wall, "part_s": part_s, "budget_s": EP_BUDGET_S}


# [dryrun]: the dry run's prediction (``launch.dryrun``: a cell laid out
# on fake tensors at a one-rank mesh and counted by the op-cost recorder)
# held against the same work run for real on the card
DRYRUN_BUDGET_S = 45
DRYRUN_TRAIN_STEPS = 3             # step 1 counted by FlopCounterMode
DRYRUN_DECODE = dict(arch="qwen2-72b", layers=8, batch=8, seq=4096,
                     kv_bits=8, steps=16)
DRYRUN_PEAK_TOL = 0.10             # predicted peak against the measured


def dryrun_predict(cfg, shape, *, hp=None, kv_bits: int = 0):
    """The dry run's recorder of one cell on a one-rank ("data", "model")
    mesh over the fake group, fake tensors on the card's device type,
    and its lay-out seconds."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_group, make_test_mesh
    t0 = time.perf_counter()
    with fake_group(1):
        mesh = make_test_mesh((1, 1), ("data", "model"), device="cuda")
        rec = dryrun.lower_cell(cfg, shape, mesh, kv_bits=kv_bits, hp=hp)
    return rec, time.perf_counter() - t0


def dryrun_compare(tag: str, rec, lay_s: float, *, flops: float,
                   peak: int, step_ms: float, what: str) -> dict:
    """Print and gate one arm's three comparisons: counted FLOPs fake
    against real (equal), the predicted peak against
    ``max_memory_allocated`` (within ``DRYRUN_PEAK_TOL``), and the
    roofline bound at the card's data-sheet peaks against the measured
    step (the roofline fraction on the card)."""
    from repro_torch.benchmarks.roofline import HBM_BW, PEAK_FLOPS
    pred_peak = rec.memory["peak"]
    compute_ms = rec.total.flops / PEAK_FLOPS * 1e3
    memory_ms = rec.total.hbm_bytes / HBM_BW * 1e3
    bound_ms = max(compute_ms, memory_ms)
    by = "operations" if compute_ms >= memory_ms else "bytes"
    ratio = pred_peak / peak
    print(f"{tag} {what}: laid out in {lay_s:.1f} s, "
          f"{sum(r['count'] for r in rec.by_op.values())} ops counted",
          flush=True)
    print(f"{tag} FLOPs fake {rec.total.flops:.6e} real {flops:.6e} "
          f"equal {rec.total.flops == flops}", flush=True)
    print(f"{tag} peak predicted {pred_peak / 2 ** 30:.3f} GiB measured "
          f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated), ratio "
          f"{ratio:.4f}", flush=True)
    print(f"{tag} roofline bound {bound_ms:.3f} ms (compute "
          f"{compute_ms:.3f}, memory {memory_ms:.3f} ms of "
          f"{rec.total.hbm_bytes / 1e9:.2f} GB: {by}) against a measured "
          f"{step_ms:.3f} ms step: fraction {bound_ms / step_ms:.4f}",
          flush=True)
    if rec.total.flops != flops:
        raise RuntimeError(f"{tag} the dry run's FLOPs are not the real "
                           f"step's")
    if abs(ratio - 1.0) > DRYRUN_PEAK_TOL:
        raise RuntimeError(f"{tag} the predicted peak misses the measured "
                           f"by {ratio - 1.0:+.1%}")
    return {"flops": flops, "pred_peak": pred_peak, "peak": peak,
            "peak_ratio": ratio, "hbm_bytes": rec.total.hbm_bytes,
            "compute_ms": compute_ms, "memory_ms": memory_ms,
            "bound_ms": bound_ms, "bound_by": by, "step_ms": step_ms,
            "roofline_fraction": bound_ms / step_ms, "lay_out_s": lay_s}


def dryrun_train(seed: int) -> dict:
    """(a) ``[train]``'s arm 1 (deepseek-7b at published widths cut to
    ``TRAIN_LAYERS`` layers, ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens,
    ``TRAIN_LR``, fp32 moments): laid out, then ``DRYRUN_TRAIN_STEPS``
    real plain steps from a seeded model on ``lm_batch`` tokens, the
    peak read from a reset after the state and batches exist, step 1
    under ``FlopCounterMode``, the others timed by CUDA events after a
    device sync each."""
    import dataclasses as dc
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.lm import lm_batch
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models.transformer import init_model
    from repro_torch.optim.adamw import AdamWConfig

    cfg = dc.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_LAYERS)
    hp = steps_mod.TrainHParams(lr=TRAIN_LR,
                                adamw=AdamWConfig(quantize_moments=False))
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec, lay_s = dryrun_predict(cfg, shape, hp=hp)
    dcfg = train_data(cfg, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed)
    model = init_model(cfg, seed=seed, device="cuda", trainable=True)
    state = steps_mod.init_train_state(cfg, hp, model=model)
    step = steps_mod.make_train_step(cfg, hp)
    batches = [{k: v.to("cuda") for k, v in lm_batch(dcfg, i).items()}
               for i in range(DRYRUN_TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        step(state, batches[0])
    times = []
    for b in batches[1:]:
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        _, m = step(state, b)
        e.record()
        times.append((s, e))
    torch.cuda.synchronize()
    step_ms = float(np.mean([a.elapsed_time(b) for a, b in times]))
    peak = torch.cuda.max_memory_allocated()
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise RuntimeError("[dryrun] (a) the real step's loss is not finite")
    del state, model, batches
    gc.collect()
    torch.cuda.empty_cache()
    out = dryrun_compare(
        "[dryrun] (a)", rec, lay_s, flops=fc.get_total_flops(), peak=peak,
        step_ms=step_ms,
        what=f"{TRAIN_ARCH} x {TRAIN_LAYERS} layers train step at "
             f"{TRAIN_BATCH} x {TRAIN_SEQ} (fp32 moments; step 3 loss "
             f"{loss:.4f})")
    return out


def dryrun_decode(seed: int) -> dict:
    """(b) qwen2-72b at published widths cut to 8 layers, one decode step
    at batch 8 on dense int8 slabs of 4096 tokens (the last slot of a
    full cache): laid out, then the real plain step from a seeded model,
    the first call under ``FlopCounterMode``, then 16 timed together by a
    CUDA event pair after a device sync; the peak read from a reset
    after the model and caches exist."""
    import dataclasses as dc
    import gc

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.dryrun import make_quant
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.transformer import init_cache, init_model

    d = DRYRUN_DECODE
    cfg = dc.replace(get_config(d["arch"]), num_layers=d["layers"])
    shape = ShapeConfig("decode", d["seq"], d["batch"], "decode")
    rec, lay_s = dryrun_predict(cfg, shape, kv_bits=d["kv_bits"])
    quant = make_quant(cfg, d["kv_bits"])
    model = init_model(cfg, seed=seed, device="cuda")
    caches = init_cache(cfg, quant, None, "cuda", batch=d["batch"],
                        max_len=d["seq"])
    g = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (d["batch"],), generator=g,
                           device="cuda", dtype=torch.int32)
    step = make_decode_step(cfg, quant=quant)
    pos = d["seq"] - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        step(model, tokens, pos, caches, None)
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(d["steps"]):
        nxt, logits, caches = step(model, tokens, pos, caches, None)
    e.record()
    torch.cuda.synchronize()
    step_ms = s.elapsed_time(e) / d["steps"]
    peak = torch.cuda.max_memory_allocated()
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("[dryrun] (b) the real step's logits are not "
                           "finite")
    del model, caches, logits
    gc.collect()
    torch.cuda.empty_cache()
    return dryrun_compare(
        "[dryrun] (b)", rec, lay_s, flops=fc.get_total_flops(), peak=peak,
        step_ms=step_ms,
        what=f"{d['arch']} x {d['layers']} layers decode step at batch "
             f"{d['batch']} on dense int{d['kv_bits']} slabs of {d['seq']} "
             f"tokens ({d['steps']} steps timed)")


def dryrun_phase(seed: int) -> dict:
    """``[dryrun]``: the dry run's prediction against a real run at world
    size 1, (a) :func:`dryrun_train`, (b) :func:`dryrun_decode`, after a
    device sync with the peak reset per arm. No kernel of the port is on
    these paths (dense caches; a fake tensor reaching a kernel raises),
    and B1's count does not move. The phase's seconds against
    ``DRYRUN_BUDGET_S``. Returns the record."""
    import gc

    import torch
    from repro_torch.kernels.paged_kv_attention import \
        paged_kv_attention_chunk as b1

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(card_line(), flush=True)
    before = b1.launches
    part_s = {}
    t0 = time.perf_counter()
    train = dryrun_train(seed)
    part_s["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode = dryrun_decode(seed)
    part_s["b"] = time.perf_counter() - t0
    if b1.launches != before:
        raise RuntimeError("[dryrun] a kernel launched on the dry run's "
                           "paths")
    wall = time.perf_counter() - t_phase
    print(f"[dryrun] phase {wall:.1f} s against a {DRYRUN_BUDGET_S} s "
          f"budget ((a) {part_s['a']:.1f}, (b) {part_s['b']:.1f} s)",
          flush=True)
    return {"phase": "dryrun", "train": train, "decode": decode,
            "phase_s": wall, "part_s": part_s, "budget_s": DRYRUN_BUDGET_S}


def dense_trace(cfg, seed: int):
    """8 requests of 16-48 prompt tokens and 16 new tokens: stepwise
    prefill through the decode step stays short at full width."""
    return served_requests(cfg, seed + 1, n=8, lo=16, hi=48, max_new=16)


def dense_phase(cfg, model, seed: int) -> dict:
    """Dense KV slabs (``page_size=0``, int8 grid, stepwise prefill), on
    the short trace, against the paged gather route on the same trace:
    every request finishes, the slabs stay on the card, and the dense
    route fed the paged route's tokens passes the gate. Prints the KV
    bytes (max_len slabs against the pages the paged run allocated) and
    the peak memory of each."""
    kw = dict(kv_bits=8, attn_impl="gather", seed=seed, max_len=64,
              trace=dense_trace)
    paged = serve_once(cfg, model, tap=True, **kw)
    dense = serve_once(cfg, model, page_size=0, **kw)
    forced = serve_once(cfg, model, page_size=0,
                        forced={r.rid: r.out for r in paged[0]}, **kw)
    ref_out = [r.out for r in paged[0]]
    gate = accuracy_gate(ref_out, [r.out for r in forced[0]])
    free = accuracy_gate(ref_out, [r.out for r in dense[0]])
    cmp = compare_logits(paged[2], forced[2])
    st, pst = dense[1], paged[1]
    st.update(teacher_forced_agreement=gate["agreement"],
              teacher_forced_below_floor=gate["below_floor"],
              free_running_agreement=free["agreement"],
              paged_kv_bytes=pst["kv_bytes"],
              paged_peak_pages=pst["peak_pages"],
              paged_max_memory_allocated_gib=pst["max_memory_allocated_gib"],
              paged_tok_per_s=pst["tok_per_s"], **cmp)
    print(f"[dense] kv_bits=8 page_size=0: {st['tok_per_s']:.1f} tok/s "
          f"(paged {pst['tok_per_s']:.1f}), {st['prefill_forwards']} "
          f"stepwise prefill forwards (paged {pst['prefill_forwards']} "
          f"bucketed), decode step {st['decode_step_ms']:.2f} ms x "
          f"{dense[1]['decode_steps']}; KV {st['kv_bytes'] / 2 ** 20:.2f} "
          f"MiB of max_len slabs against {pst['kv_bytes'] / 2 ** 20:.2f} "
          f"MiB in {pst['peak_pages']} allocated pages a pool; peak "
          f"{st['max_memory_allocated_gib']:.2f} GiB (paged "
          f"{pst['max_memory_allocated_gib']:.2f} GiB)", flush=True)
    print(f"[dense] dense vs paged gather tokens: teacher-forced agreement "
          f"{gate['agreement']:.4f} ({gate['below_floor']} below 0.5), "
          f"free-running {free['agreement']:.4f}; logits differ by at most "
          f"{cmp['max_abs_logit_diff']:.4g} over {cmp['steps']} steps",
          flush=True)
    if not gate["passed"]:
        raise AssertionError(f"dense vs paged tokens fail the gate: {gate}")
    return {"dense": st}


def quant_forward_phase(cfg, model, seed: int) -> dict:
    """One forward of the served model under a uniform policy, weights
    Q2.6 and residual data Q4.12 (``build_model_quant``): the logits are
    finite, and equal bitwise a forward with only the data quant after
    every weight was fake-quantized in place (so the forward used the
    grid values); each weight fake-quantized again is unchanged. Then
    the policy's traffic and footprint report for the full 80-layer
    config (host arithmetic). Runs last: it overwrites the weights."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.fixedpoint import FixedPointFormat, fake_quant
    from repro_torch.core.policy import PrecisionPolicy
    from repro_torch.models.transformer import forward
    from repro_torch.quant.apply import (build_model_quant,
                                         policy_footprint_report,
                                         transformer_layer_names)

    w_fmt, d_fmt = FixedPointFormat(2, 6), FixedPointFormat(4, 12)
    names = transformer_layer_names(cfg)
    quant = build_model_quant(PrecisionPolicy.uniform(names, w_fmt, d_fmt),
                              cfg, quantize_kv=False)
    data_only = build_model_quant(PrecisionPolicy.uniform(names, None,
                                                          d_fmt),
                                  cfg, quantize_kv=False)
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)).astype(
        np.int32)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        _, logits, _, _ = forward(model, tokens, cfg, quant=quant)
        b.record()
        torch.cuda.synchronize()
        ms = a.elapsed_time(b)
        if logits.shape != (2, 64, cfg.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError("quantized forward: bad logits")
        moved, n_w = 0, 0
        for blk in model.layers:
            for mod in (blk.attn, blk.mlp):
                for _, w in mod.named_parameters(recurse=False):
                    if w.dim() < 2:
                        continue
                    q = fake_quant(w, w_fmt.int_bits, w_fmt.frac_bits)
                    moved += int((q != w).sum())
                    w.copy_(q)
                    n_w += 1
                    if not torch.equal(fake_quant(w, w_fmt.int_bits,
                                                  w_fmt.frac_bits), w):
                        raise AssertionError("a fake-quantized weight is "
                                             "off the grid")
        _, again, _, _ = forward(model, tokens, cfg, quant=data_only)
    if not torch.equal(again, logits):
        raise AssertionError("the quantized forward did not use the "
                             "weights' grid values")
    full = get_config("qwen2-72b")
    report = policy_footprint_report(
        PrecisionPolicy.uniform(transformer_layer_names(full), w_fmt,
                                d_fmt), full, batch=8, seq_len=576)
    out = {"quant_forward_ms": ms, "weights_checked": n_w,
           "weight_values_moved": moved,
           "max_memory_allocated_gib":
               torch.cuda.max_memory_allocated() / 2 ** 30,
           "footprint_report_qwen2_72b_80_layers": report}
    print(f"[quant] weights {w_fmt.short()}, data {d_fmt.short()}: forward "
          f"of 2 x 64 tokens {ms:.2f} ms ({cfg.num_layers} layers, "
          f"{cfg.dtype}), logits finite "
          f"and equal to the data-only forward on pre-quantized weights; "
          f"{n_w} weights on the grid ({moved} values moved); peak "
          f"{out['max_memory_allocated_gib']:.2f} GiB", flush=True)
    print(f"[quant] policy_footprint_report, full qwen2-72b (80 layers), "
          f"batch 8, seq 576 (the port's count, host arithmetic): "
          f"{json.dumps(report)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 4: the paper's CNN experiment (no kernel: torch ops, as the
# reference runs jnp there)
# ---------------------------------------------------------------------------
CNN_POLICIES = (    # (weight I.F or None, data I.F or None), first layer
    (None, None, False), ((1, 8), (6, 4), False), ((1, 6), (4, 2), False),
    ((1, 4), (3, 1), False), ((1, 2), (2, 1), False), ((1, 3), None, False),
    (None, (4, 0), False), ((1, 5), (5, 2), True))  # True: layer 1 float32


def cnn_policy(spec, w, d, first_float):
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.policy import LayerPolicy, PrecisionPolicy
    if w is None and d is None:
        return None
    lp = LayerPolicy(w and FixedPointFormat(*w), d and FixedPointFormat(*d))
    layers = [lp] * len(spec.layers)
    if first_float:
        layers[0] = LayerPolicy(None, None)
    return PrecisionPolicy(spec.layer_names, tuple(layers))


def cnn_flops(spec, n: int) -> float:
    """2 x the multiply-adds of one forward of ``n`` images, from the
    spec's shapes: each conv at its output positions before the pool, each
    fc product."""
    h, w, c = spec.input_shape
    macs, flat = 0, None
    for l in spec.layers:
        if l.kind == "conv":
            if l.padding == "VALID":
                h, w = h - l.kernel + 1, w - l.kernel + 1
            macs += h * w * l.kernel * l.kernel * c * l.features
            c = l.features
            if l.pool:
                h, w = h // l.pool, w // l.pool
        else:
            flat = flat or h * w * c
            macs += flat * l.features
            flat = l.features
    return 2.0 * macs * n


def eval_device_ms(params, xv, spec, policy) -> float:
    """Device ms of one evaluation's forward (1024 images): CUDA events
    behind a ~5 ms device-side sleep, so the host's enqueue of the eager
    ops is not timed."""
    import torch
    from repro_torch.models import cnn
    wb, db = cnn.policy_bit_arrays(spec, policy)
    fn = lambda: cnn.cnn_forward_bits(params, xv, spec, wb, db)  # noqa: E731
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(5):
        torch.cuda._sleep(10_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)[len(out) // 2]


def cnn_phase() -> dict:
    """The paper's experiment through the port's benches on the card:
    train the three CNNs with the reference's recipe (cached under
    ``results/torch_cnn``), hold the card against the port on the CPU
    (logits, top-1 counts under 8 policies, a repeated evaluation), run the
    Fig. 2/3 sweeps, the Fig. 4 accounting, the greedy and sensitivity
    searches (Fig. 5 / Table 2) with their gates, and replay LeNet's greedy
    trajectory on the CPU."""
    import torch
    from repro_torch.benchmarks import (common, pareto_search,
                                        perlayer_sweep, traffic,
                                        uniform_sweep)
    from repro_torch.core.search import SearchResult
    from repro_torch.models import cnn

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    torch.cuda.synchronize()
    start_gib = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    nets, out = common.cnn_nets(), {}
    trained = {}
    for net in nets:
        t0 = time.perf_counter()
        spec, params, (xv, yv), base = common.get_cnn(net, device=dev,
                                                      retrain=True,
                                                      verbose=False)
        secs = time.perf_counter() - t0
        trained[net] = (spec, params, xv, yv, base)
        out[net] = {"baseline": base, "train_s": secs,
                    "train_steps": common._TRAIN_STEPS[net]}
        print(f"[cnn] {net}: trained {common._TRAIN_STEPS[net]} steps of "
              f"batch 64 and cached in {secs:.2f} s (with data and the "
              f"baseline eval); baseline top-1 {base:.4f} of 1024",
              flush=True)
    if trained["lenet"][4] < 0.85:
        raise RuntimeError(f"LeNet's baseline {trained['lenet'][4]} < 0.85")

    # card against the port on the CPU, on the card-trained weights
    n_off = 0
    for net in nets:
        spec, params, xv, yv, base = trained[net]
        cparams = {k: {kk: v.cpu() for kk, v in d.items()}
                   for k, d in params.items()}
        xc, yc = xv.cpu(), yv.cpu()
        lg = cnn.cnn_forward(params, xv[:64], spec).cpu()
        lc = cnn.cnn_forward(cparams, xc[:64], spec)
        err = float((lg - lc).abs().max())
        if not torch.allclose(lg, lc, rtol=TOL, atol=TOL):
            raise RuntimeError(f"{net}: card logits off the CPU's by {err}")
        counts = []
        for w, d, first in CNN_POLICIES:
            pol = cnn_policy(spec, w, d, first)
            cg = round(cnn.cnn_accuracy(params, xv, yv, spec, pol) * 1024)
            cc = round(cnn.cnn_accuracy(cparams, xc, yc, spec, pol) * 1024)
            if abs(cg - cc) > 1:
                raise RuntimeError(f"{net} {w} {d}: {cg} on the card, {cc} "
                                   "on the CPU")
            n_off += cg != cc
            counts.append((cg, cc))
        pol = cnn_policy(spec, *CNN_POLICIES[2])
        twice = [cnn.cnn_accuracy(params, xv, yv, spec, pol)
                 for _ in range(2)]
        if twice[0] != twice[1]:
            raise RuntimeError(f"{net}: one policy gave {twice}")
        out[net].update(logits_max_abs_err=err, counts=counts)
        print(f"[cnn] {net}: card vs CPU logits of 64 images max abs err "
              f"{err:.3g} (tol {TOL}); top-1 counts of 1024 under 8 "
              f"policies (card, CPU): {counts}; repeat {twice[0]:.4f} == "
              f"{twice[1]:.4f}", flush=True)
    print(f"[cnn] card vs CPU: {n_off} of {8 * len(nets)} policy counts "
          f"one sample apart", flush=True)

    # the paper's experiment: Fig. 2, Fig. 3, Fig. 4, Fig. 5 / Table 2
    t0 = time.perf_counter()
    uni = uniform_sweep.run(device=dev, verbose=False)
    t_uni = time.perf_counter() - t0
    t0 = time.perf_counter()
    per = perlayer_sweep.run(device=dev, verbose=False)
    t_per = time.perf_counter() - t0
    acct = traffic.run_accounting(verbose=False)["cnn"]
    print(f"[cnn] uniform sweep (Fig. 2) {t_uni:.2f} s, per-layer sweep "
          f"(Fig. 3) {t_per:.2f} s, 3 nets", flush=True)
    results, greedy = {}, {}
    for net in nets:
        spec, params, xv, yv, base = trained[net]
        u, p = uni[net], per[net]
        print(f"[cnn] {net}: min bits at 1% (uniform): weight frac "
              f"{u['min_weight_frac@1%']}, data int {u['min_data_int@1%']}, "
              f"data frac {u['min_data_frac@1%']}; per layer weight frac "
              f"{[r['min_weight_frac@1%'] for r in p['per_layer'].values()]}"
              f" (spread {p['weight_bits_spread']}), data int "
              f"{[r['min_data_int@1%'] for r in p['per_layer'].values()]}; "
              f"Fig. 4 accesses (M, batch 50) single W/D "
              f"{acct[net]['single']['weights_M']:.2f}/"
              f"{acct[net]['single']['data_M']:.2f}, batch W/D "
              f"{acct[net]['batch']['weights_M']:.2f}/"
              f"{acct[net]['batch']['data_M']:.2f}", flush=True)
        eval_fn = common.make_eval_fn(spec, params, xv, yv)
        init = pareto_search._init_policy(net, spec.layer_names, uni)
        res, res2 = pareto_search.searches(spec, eval_fn, base, init)
        results[net] = pareto_search.summarize(res, res2, base)
        greedy[net] = res
        if res.select(0.10) is None:
            raise RuntimeError(f"{net}: no point within 10%")
        for t in pareto_search.TOLERANCES:
            sel = res.select(t)
            if sel is not None and eval_fn(sel.policy) < base * (1 - t):
                raise RuntimeError(f"{net}: the {t:.0%} point re-evaluates "
                                   "below its tolerance")
        dev_ms = eval_device_ms(params, xv, spec, init)
        flops = cnn_flops(spec, len(xv))
        bound_ms = flops / FP32_FLOP_PER_S * 1e3
        host_ms = res.wall_seconds / res.evaluations * 1e3
        tr1 = res.select(0.01)
        s2 = results[net]["sensitivity_search"]
        out[net].update(
            evaluations=res.evaluations, search_s=res.wall_seconds,
            ms_per_eval=host_ms, device_ms_per_eval=dev_ms, flops=flops,
            bound_ms=bound_ms,
            tr=results[net]["tolerances"],
            cut_at_1pct=None if tr1 is None else 1 - tr1.traffic_ratio,
            sensitivity=s2)
        print(f"[cnn] {net}: greedy search {res.evaluations} evaluations in "
              f"{res.wall_seconds:.2f} s = {host_ms:.3f} ms an evaluation "
              f"(its forward {dev_ms:.3f} ms of device time, an idle share "
              f"of {1 - dev_ms / host_ms:.3f}; {flops / 1e9:.2f} GFLOP = "
              f"{flops / dev_ms / 1e9:.1f} TFLOP/s, its float32 bound "
              f"{bound_ms:.3f} ms is {bound_ms / dev_ms:.3f} of it); "
              f"{len(res.trajectory)} points", flush=True)
        for tol, r in results[net]["tolerances"].items():
            print(f"[cnn] {net}:   tol {tol:>3}: TR {r['traffic_ratio']:.4f} "
                  f"acc {r['accuracy']:.4f} bits (W.D) "
                  f"{'-'.join(r['bits_per_layer(W.D)'])}", flush=True)
        cut, paper = out[net]["cut_at_1pct"], pareto_search.PAPER_TR_1PCT[net]
        print(f"[cnn] {net}: 1 - TR at 1% = "
              f"{'none' if cut is None else f'{cut:.4f}'} (paper Table 2 "
              f"TR@1% {paper}, a cut of {1 - paper:.2f}; abstract: 74% "
              f"average, 92% best); sensitivity search {s2['evaluations']} "
              f"evaluations, TR@1% {s2['tr@1%']}", flush=True)
    common.save_json("pareto_search.json", results)
    sel = greedy["lenet"].select(0.01)
    if sel is None or sel.traffic_ratio >= 1.0:
        raise RuntimeError("LeNet's greedy search did not move at 1%")

    # LeNet's greedy trajectory replayed on the CPU
    spec, params, xv, yv, base = trained["lenet"]
    cparams = {k: {kk: v.cpu() for kk, v in d.items()}
               for k, d in params.items()}
    xc, yc, res = xv.cpu(), yv.cpu(), greedy["lenet"]
    replay, off = [], 0
    for p in res.trajectory:
        acc = cnn.cnn_accuracy(cparams, xc, yc, spec, p.policy)
        if abs(acc - p.accuracy) * 1024 > 1 + 1e-9:
            raise RuntimeError(f"replay: {acc} on the CPU, {p.accuracy} on "
                               "the card")
        off += acc != p.accuracy
        replay.append(dataclasses.replace(p, accuracy=acc))
    cbase = cnn.cnn_accuracy(cparams, xc, yc, spec)
    csel = SearchResult(cbase, replay, 0, 0.0).select(0.01)
    if csel is None or csel.policy != sel.policy:
        raise RuntimeError("the CPU replay selects another 1% point")
    peak = torch.cuda.max_memory_allocated() / 2**30
    wall = time.perf_counter() - t_phase
    print(f"[cnn] LeNet's {len(replay)} trajectory points replayed on the "
          f"CPU: {off} one sample apart, the same 1% point; peak device "
          f"memory {peak:.3f} GiB ({start_gib:.3f} GiB held before the "
          f"phase); phase {wall:.1f} s", flush=True)
    cuts = [out[n]["cut_at_1pct"] for n in nets
            if out[n]["cut_at_1pct"] is not None]
    print(f"[cnn] mean cut at 1% over the {len(cuts)} nets with a 1% point "
          f"{np.mean(cuts):.4f} (paper abstract: 74% average, 92% best)",
          flush=True)
    return {"nets": out, "peak_gib": peak, "phase_s": wall,
            "replay_off": off, "card_cpu_counts_off": n_off}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase",
                    choices=["all", "kernels", "cnn", "tier", "moe",
                             "ssm", "frontend", "bench", "replicas",
                             "train", "train2", "dist", "ep", "dryrun"],
                    default="all")
    ap.add_argument("--out", default="",
                    help="also write the full record as JSON to this path")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port is not at {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    global accuracy_gate, decode_agreement, DecodeTap, FusedTap
    from repro_torch.benchmarks import lm_precision
    from repro_torch.benchmarks.lm_precision import (  # noqa: F811
        DecodeTap, FusedTap, decode_agreement)
    accuracy_gate = functools.partial(lm_precision.accuracy_gate, **GATE)
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if args.phase == "dist":
        dist_phase(SEED)
        return 0
    if args.phase == "ep":
        ep_phase(SEED)
        return 0
    if args.phase == "dryrun":
        dryrun_phase(SEED)
        return 0
    if args.phase == "cnn":
        cnn_phase()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    t0 = time.perf_counter()
    built = build.build_all()
    if args.phase == "tier":
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
        tier_only(SEED, NUM_LAYERS)
        return 0
    if args.phase == "moe":
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
        moe_phase(SEED)
        return 0
    if args.phase == "ssm":
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
        ssm_phase(SEED)
        return 0
    if args.phase == "frontend":
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
        frontend_phase(SEED)
        return 0
    if args.phase == "bench":
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
        bench_phase(SEED)
        return 0
    if args.phase == "replicas":
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
        replicas_phase(SEED)
        return 0
    if args.phase == "train":
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
        train_phase(SEED)
        return 0
    if args.phase == "train2":
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
        train2_phase(SEED)
        return 0
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{sorted(built) or 'nothing (cached)'}", flush=True)
    hmma = kernel_build_report()

    cases = kernels_phase(SEED)
    more = entry_point_phase(SEED)
    launches, runs, cnn_record = None, [], None
    if args.phase == "all":
        launches, runs = serve_phase(SEED, NUM_LAYERS)
        moe_launches, moe_runs = moe_phase(SEED)
        ssm_launches, ssm_runs = ssm_phase(SEED)
        fe_launches, fe_runs = frontend_phase(SEED)
        bench_launches, bench_runs = bench_phase(SEED)
        rep_launches, rep_runs = replicas_phase(SEED)
        train_launches, train_runs = train_phase(SEED)
        train2_launches, train2_runs = train2_phase(SEED)
        dist_record = dist_phase(SEED)
        ep_record = ep_phase(SEED)
        dryrun_record = dryrun_phase(SEED)
        launches += (moe_launches + ssm_launches + fe_launches
                     + bench_launches + rep_launches + train_launches
                     + train2_launches)
        runs += (moe_runs + ssm_runs + fe_runs + bench_runs + rep_runs
                 + train_runs + train2_runs
                 + [dist_record, ep_record, dryrun_record])
        cnn_record = cnn_phase()
    main_case = next(c for c in cases if c["bits"] == 8 and c["S"] == 1)
    entries = [kernel_entry("paged_kv_attention", SOURCE, REPLACES, cases,
                            main_case, launches)] + more
    record = {"card": card, "hmma": hmma, "kernels": entries,
              "served": runs, "cnn": cnn_record}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(f"[total] {time.perf_counter() - t_start:.1f} s of chip_smoke.py "
          f"(build included) before the kernels' record", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    if args.phase != "all":
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
