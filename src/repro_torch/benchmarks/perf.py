"""Perf-loop tooling over the dry run's records: diff two tags of a cell
and append to the perf log, the reference's ``benchmarks/perf.py``.

Per iteration:
  1. the baseline cell exists under ``results/torch_dryrun/baseline/``
  2. run the candidate: ``python -m repro_torch.launch.dryrun --arch A
     --shape S --mesh single --tag <variant> [--set field=value]
     [--kv-bits N]``
  3. ``python -m repro_torch.benchmarks.perf diff A S <variant>`` prints
     the roofline terms' deltas (bounds at the card's peaks, counted on
     the CPU: ``benchmarks.roofline``)
  4. :func:`log_entry` appends hypothesis and verdict to
     ``results/torch_perf_log.json``, which ``benchmarks.report`` renders
"""
from __future__ import annotations

import argparse
import json
import os

from . import common
from .roofline import analyze_record, records_dir


def load_cell(arch, shape, tag="baseline", mesh="single"):
    path = os.path.join(records_dir(tag), f"{mesh}_{arch}_{shape}.json")
    with open(path) as f:
        return json.load(f)


def terms(rec):
    a = analyze_record(rec)
    return {k: a[k] for k in ("compute_s", "memory_s", "collective_s",
                              "dominant", "roofline_fraction", "fit_bytes")}


def diff(arch, shape, tag, base_tag="baseline", mesh="single"):
    b = terms(load_cell(arch, shape, base_tag, mesh))
    v = terms(load_cell(arch, shape, tag, mesh))
    print(f"{arch}/{shape} [{base_tag} -> {tag}]")
    for k in ("compute_s", "memory_s", "collective_s"):
        delta = (v[k] - b[k]) / b[k] if b[k] else float("inf")
        print(f"  {k:14s} {b[k]:10.3f} -> {v[k]:10.3f}  ({delta:+.1%})")
    print(f"  dominant       {b['dominant']} -> {v['dominant']}")
    print(f"  roofline frac  {b['roofline_fraction']:.3f} -> "
          f"{v['roofline_fraction']:.3f}")
    print(f"  fit GiB        {b['fit_bytes'] / 2**30:.1f} -> "
          f"{v['fit_bytes'] / 2**30:.1f}")
    return b, v


def log_entry(**e):
    path = common.RESULTS / "torch_perf_log.json"
    log = json.loads(path.read_text()) if path.exists() else []
    log.append(e)
    common.save_json("perf_log.json", log)
    print(f"logged iteration {e.get('iter')} for "
          f"{e.get('arch')}/{e.get('shape')}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("diff")
    for a in ("arch", "shape", "tag"):
        d.add_argument(a)
    d.add_argument("--base", default="baseline")
    d.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    if args.cmd == "diff":
        diff(args.arch, args.shape, args.tag, args.base, args.mesh)


if __name__ == "__main__":
    main()
