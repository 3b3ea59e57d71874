#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the repository's root, on a machine with as many CUDA cards as
the cell asks for (``BENCHMARK.json``). The last line of standard output
is the result: one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and, traced, ``breakdown``), and
last ``checks``, each number compared with its limit; the same numbers
end standard error. Without the cards, without the program (``src/``),
or with JAX or the JAX package loaded, it exits non-zero and prints no
result.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache of the run lives in the checkout, at
    # fixed paths (the program's kernels build into build/kernels/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this "
              "checkout", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import core
    spec = core.load_cell(args.workload)
    import torch
    want = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"bench: the cell needs {want} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    result = core.run_cell(spec, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace))
    bad = core.forbidden_loaded()
    if bad:
        print(f"bench: the process loaded {', '.join(bad)}: the port's "
              "benchmark must not import JAX or the JAX package",
              file=sys.stderr)
        return 3
    print("bench: " + json.dumps(result.pop("notes", {}), default=str),
          file=sys.stderr)
    for line in core.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
