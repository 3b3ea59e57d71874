"""Roofline analysis of the dry run's records (``launch.dryrun``), the
reference's ``benchmarks/roofline.py`` at the card's peaks.

Three terms per (arch x shape x mesh), all PER-RANK-PER-STEP seconds:

  compute    = FLOPs_rank / PEAK_FLOPS      (989e12: dense bf16)
  memory     = HBM_bytes_rank / HBM_BW      (3.35e12 B/s)
  collective = wire_bytes_rank / LINK_BW    (50e9 B/s)

The constants are one NVIDIA H100 80GB HBM3's at its 700 W power limit
(NVIDIA's data sheet, SXM part, dense rates), not measurements.
``LINK_BW`` is the slowest link on a ring of the group: a 16-rank model
axis spans two 8-GPU NVLink nodes, so its ring crosses a 400 Gb/s
InfiniBand link, 50e9 B/s. The FLOPs, bytes and wire bytes come from
the op-level cost recorder (``launch.hlo_cost``): every op an eager step
dispatches, a dot's FLOPs over its contracting dims, each op's input and
output bytes (an eager op is one launch), each collective's ring-model
wire bytes. They are counted on the CPU, on fake tensors: bounds, not
times.

MODEL_FLOPS = 6*N_active*tokens (train) or 2*N_active*tokens
(inference); the ratio MODEL_FLOPS / (FLOPs_rank * n_ranks) exposes
recomputation and redundancy (ranks of the model axis that compute the
same rows).

Memory fit: the recorder tracks live storages, in-place updates
included (a state or cache updated in place is an alias, not a second
copy), so ``fit_bytes`` is the tracked per-rank peak. (The reference
subtracts its donated arguments, since XLA:CPU does not alias them.)
"""
from __future__ import annotations

import glob
import json
import os

from . import common

PEAK_FLOPS = 989e12          # dense bf16 / card
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 50e9               # bytes/s: 400 Gb/s InfiniBand between nodes
HBM_BYTES = 80e9             # H100 80GB HBM3
CARD = "NVIDIA H100 80GB HBM3 (700 W)"


def records_dir(tag="baseline") -> str:
    """Where the dry run writes the records of ``tag``."""
    return os.path.join(str(common.RESULTS), "torch_dryrun", tag)


def analyze_record(rec) -> dict:
    n_dev = 512 if rec["mesh"] == "multi" else 256
    lc = rec["loop_cost"]
    mem = rec.get("memory", {})
    m = rec["model"]

    compute_s = lc["flops"] / PEAK_FLOPS
    memory_s = lc["hbm_bytes"] / HBM_BW
    coll_s = lc["wire_bytes"] / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": coll_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    # MFU-style roofline fraction: useful model flops over the time the
    # dominant term implies, against the compute peak
    model_flops_dev = m["model_flops"] / n_dev
    roofline_frac = (model_flops_dev / PEAK_FLOPS) / bound if bound else 0.0

    args = mem.get("argument_size_in_bytes", 0)
    temp = mem.get("temp_size_in_bytes", 0)
    fit_bytes = mem.get("peak_memory_in_bytes", args + temp)
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": coll_s, "dominant": dominant,
        "step_time_lower_bound_s": bound,
        "model_flops": m["model_flops"],
        "hlo_flops_dev": lc["flops"],
        "useful_flops_ratio": model_flops_dev / lc["flops"]
        if lc["flops"] else 0.0,
        "roofline_fraction": roofline_frac,
        "fit_bytes": fit_bytes, "fits_hbm": bool(fit_bytes <= HBM_BYTES),
        "arg_bytes": args, "temp_bytes": temp,
        "collective_breakdown": lc.get("collectives", {}),
        "compile_s": rec.get("compile_s"),
    }


_SUGGEST = {
    "compute": "compute-bound: raise tensor-core utilization (bigger "
               "per-rank tiles, fewer recomputes, no redundant rows over "
               "the model axis) or accept — this is the healthy regime",
    "memory": "HBM-bound: cut bytes/step — lower-precision residents "
              "(paper's per-layer bits / int8 KV), fused kernels in place "
              "of eager ops, larger arithmetic intensity per pass",
    "collective": "link-bound: reshard to cut all-gather/all-reduce "
                  "volume, overlap collectives with compute, or quantize "
                  "the wire format (int8 dispatch / grad compression)",
}


def load_all(tag="baseline"):
    recs = []
    for path in sorted(glob.glob(os.path.join(records_dir(tag), "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if not rec.get("skipped") and "loop_cost" in rec:
            recs.append(analyze_record(rec))
    return recs


def table(recs, *, mesh="single") -> str:
    rows = [f"| arch | shape | compute s | memory s | collective s | "
            f"dominant | roofline frac | useful/HLO flops | fits 80G |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh:
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.3f} | "
            f"{r['dominant']} | {r['roofline_fraction']:.2f} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{'Y' if r['fits_hbm'] else 'N'} |")
    return "\n".join(rows)


def run(*, verbose=True, tag="baseline"):
    recs = load_all(tag)
    if not recs:
        if verbose:
            print("[roofline] no dry-run records found; run "
                  "python -m repro_torch.launch.dryrun first")
        return []
    out = {"records": recs,
           "suggestions": {r["arch"] + "/" + r["shape"]:
                           _SUGGEST[r["dominant"]]
                           for r in recs if r["mesh"] == "single"}}
    common.save_json(f"roofline_{tag}.json", out)
    if verbose:
        print(f"[roofline] single-pod table (tag={tag}), bounds at the "
              f"{CARD} data sheet's peaks:")
        print(table(recs, mesh="single"))
    return recs


if __name__ == "__main__":
    import sys
    run(tag=sys.argv[1] if len(sys.argv) > 1 else "baseline")
