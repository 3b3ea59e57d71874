"""The control of a cell's ``correct``, read on the chip at the cell's own
size: whole runs of the cell (the program against the reference, as the
benchmark runs it) that also read the same numbers for the reference put
in the program's place in a lower precision (float8 e4m3 operands), and
for a training cell the reference with half of its batch left out; or,
with ``--program-kv-bits``, the program's own lower-precision KV path.
One JSON line per seed, with the program's readings and the control's.

    python3 bench/tools/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 20 [--program-kv-bits 4] [--out FILE]
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--program-kv-bits", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench import core
    rows = []
    for seed in (int(x) for x in args.seeds.split(",")):
        spec = core.load_cell(args.workload)
        if spec.cell["driver"] == "train_loop":
            spec.overrides["controls"] = ["fp8", "half_batch"]
        elif args.program_kv_bits:
            spec.overrides["program"] = {"kv_bits": args.program_kv_bits}
        else:
            spec.overrides["control"] = True
        res = core.run_cell(spec, seed=seed, seconds=args.seconds,
                            trace=False)
        row = {"seed": seed, "checks": res["checks"], "notes": res["notes"],
               "metrics": res["metrics"]}
        rows.append(row)
        print(json.dumps(row, default=str), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
