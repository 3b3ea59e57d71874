"""Kernel benchmarks of the port: each op of ``kernels.ops`` against its
oracle in ``kernels.ref``, with the reference bench's stages, inputs and
row keys (``benchmarks/kernel_bench.py``), plus times.

    python -m repro_torch.benchmarks.kernel_bench [--only a,b] [--device D]

On the card (``--device cuda``, the default; it raises without one) each
op launches its CUDA kernel and the reference's ``interpret_*`` /
``pallas_*`` wall times become ``*_ms``: the mean device time of a few
launches, CUDA events. With
``--device cpu`` each op runs its plain PyTorch version and the times are
host seconds, named ``*_cpu_s``. The record, with the device's name, goes
to ``results/torch_kernel_bench[_<stages>].json`` under the repository.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..kernels import ops, ref

RESULTS = Path(__file__).resolve().parents[3] / "results"


def _t(x, dev):
    return torch.from_numpy(np.asarray(x)).to(dev)


def _timeit(dev: torch.device, base: str, fn, *args, reps: int = 3) -> dict:
    """{base_ms: mean device ms} on the card, {base_cpu_s: mean host s} on
    the CPU; one warm-up call first."""
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        torch.cuda.synchronize(dev)
        return {f"{base}_ms": a.elapsed_time(b) / reps}
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return {f"{base}_cpu_s": (time.perf_counter() - t0) / reps}


def _gen(dev, seed: int) -> torch.Generator:
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def bench_quant_cast(dev):
    x = torch.randn((1024, 1024), generator=_gen(dev, 0), device=dev) * 4
    out = {}
    for (i, f) in [(2, 6), (4, 4), (2, 14), (8, 8)]:
        y = ops.quant_cast(x, i, f)
        yr = ref.quant_cast_ref(x, i, f)
        out[f"Q{i}.{f}"] = {
            "max_err_vs_ref": float((y - yr).abs().max()),
            **_timeit(dev, "kernel", ops.quant_cast, x, i, f),
            "hbm_bytes_fp32": x.numel() * 4 * 2,
            "container_bits": 8 if i + f <= 8 else 16,
        }
    return out


def bench_pack(dev):
    out = {}
    for bits in (2, 4, 8, 16):
        lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
        q = torch.randint(lo, hi + 1, (2048, 512), generator=_gen(dev, 1),
                          device=dev, dtype=torch.int32)
        w = ops.pack(q, bits)
        rt = ops.unpack(w, bits)
        out[f"{bits}b"] = {
            "roundtrip_exact": bool(torch.equal(q, rt)),
            "matches_ref": bool(torch.equal(w, ref.pack_ref(q, bits))),
            "footprint_ratio_vs_int32": w.numel() / q.numel(),
            "footprint_ratio_vs_fp32": w.numel() / q.numel(),
            **_timeit(dev, "pack", ops.pack, q, bits),
            **_timeit(dev, "unpack", ops.unpack, w, bits),
        }
    return out


def bench_quant_matmul(dev):
    out = {}
    for (m, k, n) in [(256, 1024, 256), (512, 4096, 512)]:
        a = torch.randn((m, k), generator=_gen(dev, 2), device=dev)
        wq = torch.randint(-128, 128, (k, n), generator=_gen(dev, 3),
                           device=dev).to(torch.int8)
        s = 0.001 + 0.019 * torch.rand((n,), generator=_gen(dev, 4),
                                       device=dev)
        y = ops.qmatmul(a, wq, s)
        yr = ref.quant_matmul_ref(a, wq, s)
        out[f"{m}x{k}x{n}"] = {
            "rel_err_vs_ref": float((y - yr).abs().max()
                                    / (yr.abs().max() + 1e-9)),
            "weight_hbm_bytes": int(wq.numel() + n * 4),
            "weight_hbm_bytes_bf16": int(k * n * 2),
            "weight_traffic_ratio": (wq.numel() + n * 4) / (k * n * 2),
            **_timeit(dev, "kernel", ops.qmatmul, a, wq, s),
        }
    return out


def bench_kv_attention(dev):
    out = {}
    for (b, h, kv, hd, t) in [(4, 8, 2, 64, 512), (2, 16, 16, 128, 1024)]:
        q = torch.randn((b, h, hd), generator=_gen(dev, 5), device=dev)
        k_q = torch.randint(-128, 128, (b, t, kv, hd), generator=_gen(dev, 6),
                            device=dev).to(torch.int8)
        v_q = torch.randint(-128, 128, (b, t, kv, hd), generator=_gen(dev, 7),
                            device=dev).to(torch.int8)

        def run(q, k, v):
            return ops.kv_attention(q, k, v, t - 5, int_bits=2, frac_bits=6,
                                    block_t=128)
        y = run(q, k_q, v_q)
        yr = ref.kv_attention_ref(q, k_q, v_q, 2, 6, t - 5)
        out[f"B{b}H{h}KV{kv}hd{hd}T{t}"] = {
            "max_err_vs_ref": float((y - yr).abs().max()),
            "cache_bytes_int8": int(k_q.numel() + v_q.numel()),
            "cache_bytes_bf16": int((k_q.numel() + v_q.numel()) * 2),
            "cache_traffic_ratio": 0.5,
            **_timeit(dev, "kernel", run, q, k_q, v_q),
        }
    return out


def _pool(rng, dev, B, NP, ps, kv, hd, bits):
    return [_t(x, dev) for x in ref.make_fragmented_pool(rng, B, NP, ps, kv,
                                                         hd, bits)]


def bench_paged_prefill_chunk(dev):
    """Prefill-chunk attention, S in {8, 32, 128}: the chunk op vs the
    gather oracle on fragmented page tables, int4/int8/fp pages, per-row
    starts that straddle page boundaries."""
    out = {}
    B, kv, g, hd, ps = 2, 2, 2, 32, 16
    for S in (8, 32, 128):
        starts = np.array([3, ps - 1], np.int32)[:B]
        NP = -(-int(starts.max() + S) // ps)
        for bits, cont in ((0, "fp"), (8, "int8"), (4, "int4")):
            rng = np.random.default_rng(S * 10 + bits)
            pool = _pool(rng, dev, B, NP, ps, kv, hd, bits)
            q = _t(rng.normal(size=(B, S, kv * g, hd)).astype(np.float32),
                   dev)
            args = (q, *pool, _t(starts, dev), _t(starts + S, dev))
            y = ops.paged_kv_attention_chunk(*args, bits=bits)
            yr = ref.paged_kv_attention_chunk_ref(*args, bits=bits)
            out[f"S{S}-{cont}"] = {
                "max_err_vs_gather": float((y - yr).abs().max()),
                "pages": int(NP), "page_size": ps, "fragmented": True,
                **_timeit(dev, "kernel", lambda *a: ops.
                          paged_kv_attention_chunk(*a, bits=bits), *args,
                          reps=1),
                **_timeit(dev, "gather", lambda *a: ref.
                          paged_kv_attention_chunk_ref(*a, bits=bits), *args,
                          reps=1),
            }
    return out


def bench_fused_step(dev):
    """Ragged fused-cycle attention: one chunk launch where a decode row
    (one real query padded into the bucket S) rides beside a prefill row,
    against two launches; errors as the reference bench's."""
    out = {}
    kv, g, hd, ps = 2, 2, 32, 16
    for S in (8, 32):
        for bits, cont in ((0, "fp"), (8, "int8"), (4, "int4")):
            rng = np.random.default_rng(S * 7 + bits)
            dec_pos, pre_start = 2 * ps + 3, ps - 1
            NP = -(-max(dec_pos + 1, pre_start + S) // ps)
            kq, vq, ks, vs, pt = _pool(rng, dev, 2, NP, ps, kv, hd, bits)
            q = _t(rng.normal(size=(2, S, kv * g, hd)).astype(np.float32),
                   dev)
            qs = _t(np.array([dec_pos, pre_start], np.int32), dev)
            lens = _t(np.array([dec_pos + 1, pre_start + S], np.int32), dev)

            def ref_fn(q, pt, qs, lens):
                return ref.paged_kv_attention_chunk_ref(
                    q, kq, vq, ks, vs, pt, qs, lens, bits=bits)

            def two_launches(q, pt, qs, lens):
                return (ref_fn(q[:1, :1], pt[:1], qs[:1], lens[:1]),
                        ref_fn(q[1:], pt[1:], qs[1:], lens[1:]))

            fused = ref_fn(q, pt, qs, lens)
            dec, pre = two_launches(q, pt, qs, lens)
            y = ops.paged_kv_attention_chunk(q, kq, vq, ks, vs, pt, qs, lens,
                                             bits=bits)
            out[f"S{S}-{cont}"] = {
                "decode_pad_err": float((fused[0, 0] - dec[0, 0]).abs().max()),
                "prefill_row_err": float((fused[1] - pre[0]).abs().max()),
                "max_err_vs_gather": max(
                    float((y[0, 0] - fused[0, 0]).abs().max()),
                    float((y[1] - fused[1]).abs().max())),
                "launches_per_cycle_fused": 1,
                "launches_per_cycle_separate": 2,
                **_timeit(dev, "fused_1launch", ref_fn, q, pt, qs, lens,
                          reps=1),
                **_timeit(dev, "separate_2launch", two_launches, q, pt, qs,
                          lens, reps=1),
            }
    return out


def bench_paged_decode_gap(dev):
    """Decode-step attention (S = 1) on identical fragmented page tables:
    the default chunk kernel, the KV-head-blocked one (``block_kv=True``:
    each page read once per query block, all KV heads) and the gather
    oracle. ``blocked_vs_default_err`` is 0.0 on int8/int4 pages (the
    tensor-core kernels take the same tiles and splits) and float rounding
    on the float32 ``fp`` pages (the FMA kernels)."""
    out = {}
    B, kv, g, hd, ps = 2, 2, 2, 32, 16
    for ctx in (64, 256):
        NP = -(-ctx // ps)
        for bits, cont in ((0, "fp"), (8, "int8"), (4, "int4")):
            rng = np.random.default_rng(ctx + bits)
            pool = _pool(rng, dev, B, NP, ps, kv, hd, bits)
            q = _t(rng.normal(size=(B, 1, kv * g, hd)).astype(np.float32),
                   dev)
            args = (q, *pool, _t(np.full((B,), ctx - 1, np.int32), dev),
                    _t(np.full((B,), ctx, np.int32), dev))

            def default(*a):
                return ops.paged_kv_attention_chunk(*a, bits=bits)

            def blocked(*a):
                return ops.paged_kv_attention_chunk(*a, bits=bits,
                                                    block_kv=True)

            def gather(*a):
                return ref.paged_kv_attention_chunk_ref(*a, bits=bits)
            y, yb, yr = default(*args), blocked(*args), gather(*args)
            out[f"ctx{ctx}-{cont}"] = {
                "max_err_vs_gather": float((y - yr).abs().max()),
                "blocked_vs_default_err": float((yb - y).abs().max()),
                "pages": int(NP), "page_size": ps, "fragmented": True,
                "blocks_default": int(B * kv),
                "blocks_blocked": int(B),
                "page_fetches_default": int(B * kv * NP * 2),
                "page_fetches_blocked": int(B * NP * 2),
                **_timeit(dev, "gather", gather, *args),
                **_timeit(dev, "default", default, *args),
                **_timeit(dev, "blocked", blocked, *args),
            }
    return out


_STAGES = {
    "quant_cast": bench_quant_cast,
    "pack": bench_pack,
    "quant_matmul": bench_quant_matmul,
    "kv_attention": bench_kv_attention,
    "paged_prefill_chunk": bench_paged_prefill_chunk,
    "fused_step": bench_fused_step,
    "paged_decode_gap": bench_paged_decode_gap,
}


def run(*, device="cuda", only=None, verbose=True, save=True) -> dict:
    """Run the stages (all, or those in ``only``) on ``device``; returns
    ``{stage: {row: {...}}}`` and saves it with the device's name."""
    dev = resolve_device(device)
    res = {name: fn(dev) for name, fn in _STAGES.items()
           if only is None or name in only}
    if verbose:
        print(f"[kernel_bench] {dev}")
        for kname, rows in res.items():
            for cfg, r in rows.items():
                err = r.get("max_err_vs_ref", r.get(
                    "max_err_vs_gather", r.get("rel_err_vs_ref",
                                               r.get("roundtrip_exact"))))
                print(f"  {kname:19s} {cfg:18s} err/ok={err} ")
    if save:
        kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        name = ("torch_kernel_bench.json" if only is None else
                f"torch_kernel_bench_{'_'.join(sorted(only))}.json")
        RESULTS.mkdir(parents=True, exist_ok=True)
        (RESULTS / name).write_text(json.dumps(
            {"device": {"type": dev.type, "kind": kind}, "stages": res},
            indent=1))
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help=f"comma list of stages ({','.join(_STAGES)})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; the default) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s] or None
    if only:
        unknown = set(only) - set(_STAGES)
        if unknown:
            raise SystemExit(f"unknown kernel_bench stages: {unknown}")
    run(device=args.device, only=only)


if __name__ == "__main__":
    main()
