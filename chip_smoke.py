#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --phase kernels
    python3 chip_smoke.py --phase cnn    # phase 4 alone, no kernel build
    python3 chip_smoke.py --phase tier   # the build and [tier] alone

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
   ``policy_footprint_report`` for the full 80-layer config;
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
import json
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
def decode_agreement(ref_outs, test_outs):
    """Token agreement of two decode runs of the same requests."""
    per, hits, total = [], 0, 0
    for ref, test in zip(ref_outs, test_outs):
        ref, test = np.asarray(ref), np.asarray(test)
        n = min(len(ref), len(test))
        h = int(np.sum(ref[:n] == test[:n]))
        per.append(h / max(n, 1))
        hits += h
        total += n
    return hits / max(total, 1), per


def accuracy_gate(ref_outs, test_outs, *, min_agreement=0.9,
                  request_floor=0.5, allowed_below_floor=0.15):
    """The JAX benches' accuracy gate: overall agreement >= min_agreement
    and at most an ``allowed_below_floor`` fraction of requests under
    ``request_floor`` (a random-init model's argmax ties can flip one
    request entirely)."""
    overall, per = decode_agreement(ref_outs, test_outs)
    below = sum(1 for a in per if a < request_floor)
    violations = max(0, below - int(allowed_below_floor * len(per)))
    violations += overall < min_agreement
    return {"agreement": overall, "below_floor": below,
            "passed": violations == 0}


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


class DecodeTap:
    """Wraps a server's decode step: records each live request's logits at
    each generation step and, given ``forced`` (rid -> a reference run's
    tokens), feeds request rid the reference's token g - 1 at its step
    g > 0 in place of its own (teacher forcing). Two routes then decode on
    identical inputs, so their choices and logits compare step by step and
    one early flip of a near-tie cannot derail the rest of a request."""

    def __init__(self, srv, forced=None):
        self.srv, self.fn, self.forced = srv, srv.decode, forced
        self.logits = {}            # (rid, step) -> (V,) logits on the card

    def __call__(self, model, tokens, pos, caches, page_table):
        import torch
        srv = self.srv
        live = [(i, r) for i, r in enumerate(srv.slots) if r is not None]
        if self.forced is not None:
            idx = [i for i, _ in live if srv.slot_gen[i] > 0]
            if idx:
                tokens = tokens.clone()
                tokens[idx] = torch.tensor(
                    [self.forced[srv.slots[i].rid][srv.slot_gen[i] - 1]
                     for i in idx], dtype=tokens.dtype, device=tokens.device)
        nxt, logits, caches = self.fn(model, tokens, pos, caches, page_table)
        for i, r in live:
            self.logits[(r.rid, srv.slot_gen[i])] = logits[i]
        return nxt, logits, caches


class FusedTap:
    """:class:`DecodeTap` for the fused step (``fused="on"``): its decode
    rows are the live slots whose prompt is consumed (a prefilling slot
    still has prompt tokens to feed). It forces their tokens as
    :class:`DecodeTap` does and records each one's logits: row i's in the
    steady state (every row emits), the k-th emitted row's in an admission
    round."""

    def __init__(self, srv, forced=None):
        self.srv, self.fn, self.forced = srv, srv._fused, forced
        self.logits = {}

    def __call__(self, model, tokens, start, valid, caches, page_table,
                 emit):
        import torch
        srv = self.srv
        dec = [(i, r) for i, r in enumerate(srv.slots) if r is not None
               and srv.pos[i] >= len(r.prompt) - 1]
        if self.forced is not None:
            idx = [i for i, _ in dec if srv.slot_gen[i] > 0]
            if idx:
                tokens = tokens.clone()
                tokens[idx, 0] = torch.tensor(
                    [self.forced[srv.slots[i].rid][srv.slot_gen[i] - 1]
                     for i in idx], dtype=tokens.dtype, device=tokens.device)
        nxt, logits, caches = self.fn(model, tokens, start, valid, caches,
                                      page_table, emit)
        steady = emit is srv._arange_dev
        for k, (i, r) in enumerate(dec):
            self.logits[(r.rid, srv.slot_gen[i])] = logits[i if steady
                                                           else k]
        return nxt, logits, caches


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
    if not srv.paged:
        return sum(t.numel() * t.element_size() for c in srv.caches
                   for t in c.values())
    per_page = sum(t[0].numel() * t.element_size() for c in srv.caches
                   for t in c.values())
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


def decode_profile(cfg, model, seed: int, *, start: int = 8,
                   steps: int = 8) -> dict:
    """The int8 kernel-route served run again, with a profiler window over
    ``steps`` decode steps: device time by kernel, B1's share (its
    tensor-core kernel and the merge of its splits) of the device time and
    of the window, and the device's idle share of the window (1 - the
    union of kernel and copy intervals over the window's wall time)."""
    import torch

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
    evs = [e for e in win.prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    window_us = win.wall_s * 1e6
    if not evs:
        print("[profile] torch.profiler recorded no device activity on "
              "this machine", flush=True)
        return {"window_us": window_us, "device_events": 0}
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    by_name = {}
    for e in evs:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.end - e.time_range.start
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
        return decode_agreement([r.out for r in a], [r.out for r in b])[0]

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
    if vocab is None:
        return reqs
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
                                [r.out for r in rc[0]])[0]
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
        _, logits, _ = forward(model, tokens, cfg, quant=quant)
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
        _, again, _ = forward(model, tokens, cfg, quant=data_only)
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
    ap.add_argument("--phase", choices=["all", "kernels", "cnn", "tier"],
                    default="all")
    ap.add_argument("--out", default="",
                    help="also write the full record as JSON to this path")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port is not at {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
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
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{sorted(built) or 'nothing (cached)'}", flush=True)
    hmma = kernel_build_report()

    cases = kernels_phase(SEED)
    more = entry_point_phase(SEED)
    launches, runs, cnn_record = None, [], None
    if args.phase == "all":
        launches, runs = serve_phase(SEED, NUM_LAYERS)
        cnn_record = cnn_phase()
    main_case = next(c for c in cases if c["bits"] == 8 and c["S"] == 1)
    entries = [kernel_entry("paged_kv_attention", SOURCE, REPLACES, cases,
                            main_case, launches)] + more
    record = {"card": card, "hmma": hmma, "kernels": entries,
              "served": runs, "cnn": cnn_record}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": entries}), flush=True)
    if args.phase != "all":
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
