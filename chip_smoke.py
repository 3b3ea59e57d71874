#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --phase kernels

Phases, each of which raises on failure (no phase is caught):

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together) and print the build time;
2. kernels vs their plain PyTorch versions at the served shapes
   (qwen2-72b attention: 64 query heads, 8 KV heads, head_dim 128, page
   size 16): decode (S = 1, 8 rows, 1-2k keys) and a 32-query prefill
   chunk, for float (bf16), int8 and int4 pages; max abs error, kernel /
   plain / bound / library times; then the kernel entry point
   (``kernels.ops``) at qwen2-72b's widths: the KV-head-blocked attention
   (``block_kv=True``) on the same six cases, ``qmatmul`` of 8 and 256
   rows by the layer-0 up-projection's int8 grid from
   ``quantize_param_tree``, ``quant_cast`` of a prefill residual and that
   weight at four formats, and ``pack``/``unpack`` of its grid at 2-16
   bits, each against its plain version; and the port's kernel bench;
3. the served main path: ``BatchedServer`` with qwen2-72b at full width
   cut to 8 layers (bf16, random weights from a seeded generator), paged
   int8 and int4 KV, bucketed prefill, 24 requests of 64-512 prompt tokens
   and 32 new tokens at batch 8, through the kernel and through the gather
   route; every request finishes, the kernel ran once per layer per
   forward, and the two routes' tokens agree.

The line before the last is the kernels' JSON record; the last line is the
run's verdict, ``{"ok": true, "device": {...}}``. Exits non-zero, with no
verdict, when there is no CUDA card or the port is not beside this file.
Float32 matmuls and convolutions run without TF32 here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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


def cuda_ms(fn, *, reps: int, flush=None) -> float:
    """Mean device ms of ``fn`` over ``reps`` launches after a warm-up,
    each timed by its own CUDA event pair; ``flush`` runs (untimed) before
    each launch to evict the inputs from L2."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush()
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
def attention_inputs(rng, *, bits: int, S: int, B: int = 8):
    """Served-width attention inputs on the card: a fragmented pool at
    1-2k keys per row, bf16 queries, the chunk's S queries ending at each
    row's last key. Returns (args, kv_len as numpy)."""
    import torch
    from repro_torch.kernels.ref import make_fragmented_pool

    dev = torch.device("cuda")
    kv_len = rng.integers(1024, 2049, B).astype(np.int32)
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
                block_kv: bool = False):
    """One kernel-vs-plain comparison at the served attention shapes,
    through ``kernels.ops``. With ``block_kv`` it is B2's: its launch is
    counted in the case and it is also held against B1 (1e-5)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_kv_attention as pka

    chunk = pka.paged_kv_attention_chunk
    args, kv_len = attention_inputs(rng, bits=bits, S=S, B=B)
    chunk.kvblock_launches = 0                  # the entry point's launch
    out = ops.paged_kv_attention_chunk(*args, bits=bits, block_kv=block_kv)
    launches = chunk.kvblock_launches
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
    plain_ms = cuda_ms(lambda: pka.paged_kv_attention_chunk_plain(
        *args, bits=bits), reps=5, flush=flush)
    lib_err, library_ms = sdpa_yardstick(args, bits=bits, plain=plain,
                                         flush=flush)
    bound_ms, bound_by, nbytes, flops = attention_bound(args, kv_len, out)
    return {"bits": bits, "S": S, "B": B, "kv_len_max": int(kv_len.max()),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "library_max_abs_err": lib_err,
            "bytes": nbytes, "flops": flops, **extra}


def attention_cases(rng, label: str, *, block_kv: bool = False):
    """The six served-width attention cases (float, int8, int4 pages x
    decode and a 32-query chunk), one printed line each."""
    cases = []
    for bits in (0, 8, 4):
        for S in (1, 32):
            c = kernel_case(rng, bits=bits, S=S, block_kv=block_kv)
            cases.append(c)
            vs_b1 = (f", vs B1 {c['max_abs_err_vs_b1']:.2e} (tol 1e-5)"
                     if block_kv else "")
            print(f"[{label}] bits={bits} S={S:>2}: max_abs_err "
                  f"{c['max_abs_err']:.2e} (tol {TOL}){vs_b1}, kernel "
                  f"{c['ms']:.4f} ms, plain {c['plain_ms']:.3f} ms, sdpa "
                  f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']})", flush=True)
    return cases


def kernels_phase(seed: int):
    return attention_cases(np.random.default_rng(seed), "kernel")


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


def qmatmul_cases(wq, scales):
    """B3: decode (8 rows) and prefill (256 rows) activations, bf16 and
    f32, times the served model's layer-0 up-projection grid."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)

    K, N = wq.shape
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    flush = flush_fn()
    cases, launches = [], 0
    for dt, tol, rate in ((torch.bfloat16, 2e-2, BF16_FLOP_PER_S),
                          (torch.float32, 1e-4, FP32_FLOP_PER_S)):
        # yardstick weight, dequantized once (not timed)
        w_deq = (wq.float() * scales[None, :]).to(dt)
        for M in (8, 256):
            a = torch.randn((M, K), generator=g, device="cuda").to(dt)
            quant_matmul.launches = 0           # the entry point's launch
            out = ops.qmatmul(a, wq, scales)
            launches += quant_matmul.launches
            torch.cuda.synchronize()
            plain = quant_matmul_plain(a, wq, scales)
            err = float((out - plain).abs().max())
            rel = err / float(plain.abs().max())
            if not (torch.isfinite(out).all() and rel <= tol):
                raise AssertionError(f"qmatmul M={M} {dt}: error {rel:.3e} "
                                     f"of max|ref| > {tol}")
            ms = cuda_ms(lambda: quant_matmul(a, wq, scales), reps=10,
                         flush=flush)
            plain_ms = cuda_ms(lambda: quant_matmul_plain(a, wq, scales),
                               reps=3, flush=flush)
            library_ms = cuda_ms(lambda: torch.matmul(a, w_deq), reps=10,
                                 flush=flush)
            nbytes = (a.numel() * a.element_size() + wq.numel()
                      * wq.element_size() + N * 4 + M * N * 4)
            flops = 2.0 * M * N * K
            bound_ms, bound_by = bound(nbytes, flops, rate)
            name = str(dt).split(".")[-1]
            c = {"M": M, "K": K, "N": N, "a_dtype": name,
                 "max_abs_err": err, "rel_err": rel, "tol": tol, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library_ms,
                 "bytes": nbytes, "flops": flops}
            cases.append(c)
            print(f"[B3 qmatmul] a ({M}, {K}) {name} x wq ({K}, {N}) int8: "
                  f"error {rel:.2e} of max|ref| (tol {tol}), kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.3f} ms, torch.matmul "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})", flush=True)
        del w_deq
    main = next(c for c in cases if c["M"] == 8 and c["a_dtype"] ==
                "bfloat16")
    return kernel_entry("quant_matmul",
                        "src/repro_torch/kernels/csrc/quant_matmul.cu",
                        "src/repro/kernels/quant_matmul.py:24", cases, main,
                        launches)


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
    so per-step device times can be read after the run."""

    def __init__(self, fn):
        self.fn = fn
        self.pairs = []

    def __call__(self, *a, **kw):
        import torch
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = self.fn(*a, **kw)
        e.record()
        self.pairs.append((s, e))
        return out

    def ms(self):
        xs = [a.elapsed_time(b) for a, b in self.pairs]
        return float(np.median(xs)) if xs else None


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


def serve_once(cfg, model, *, kv_bits: int, attn_impl: str, seed: int,
               forced=None, tap: bool = False):
    """One served run of the 24 seeded requests. Returns (requests, stats,
    DecodeTap or None)."""
    import torch
    from repro_torch.launch.serve import BatchedServer, Request

    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 513, 24)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(L)).astype(
        np.int32), 32) for i, L in enumerate(lens)]
    srv = BatchedServer(cfg, model, batch_size=8, max_len=576,
                        kv_bits=kv_bits, page_size=PS, attn_impl=attn_impl,
                        prefill="bucketed", prefill_bucket=32,
                        device="cuda")
    taps = DecodeTap(srv, forced) if tap or forced is not None else None
    srv.decode = StepTimer(taps or srv.decode)
    srv._chunk_prefill = StepTimer(srv._chunk_prefill)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(r.done and r.error is None and len(r.out) == r.max_new
               for r in reqs), "a request did not finish with its tokens"
    for pool in srv.caches:
        assert all(t.is_cuda for t in pool.values()), "a KV pool left the card"
    assert all(p.is_cuda for p in model.parameters())
    assert srv.allocator.num_free == srv.allocator.num_usable
    gen = sum(len(r.out) for r in reqs)
    return reqs, {
        "kv_bits": kv_bits, "attn_impl": attn_impl, "requests": len(reqs),
        "generated_tokens": gen, "wall_s": wall, "tok_per_s": gen / wall,
        "prefill_forwards": srv.prefill_forwards,
        "decode_steps": srv.decode_steps,
        "program_launches": srv.program_launches,
        "prefill_forward_ms": srv._chunk_prefill.ms(),
        "decode_step_ms": srv.decode.ms(),
        "max_memory_allocated_gib":
            torch.cuda.max_memory_allocated() / 2 ** 30}, taps


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
    return launches, runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=["all", "kernels"], default="all")
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
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s for "
          f"{sorted(built) or 'nothing (cached)'}", flush=True)

    cases = kernels_phase(SEED)
    more = entry_point_phase(SEED)
    launches, runs = None, []
    if args.phase == "all":
        launches, runs = serve_phase(SEED, NUM_LAYERS)
    main_case = next(c for c in cases if c["bits"] == 8 and c["S"] == 1)
    entries = [kernel_entry("paged_kv_attention", SOURCE, REPLACES, cases,
                            main_case, launches)] + more
    record = {"card": card, "kernels": entries, "served": runs}
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
