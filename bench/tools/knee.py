"""The knee sweep of a serving cell, run once when the cell is defined:
one process serves the cell's traffic at each rate in turn (the server,
its weights and its cached documents kept, the rows drained between
rates) and reports, per rate, whether the backlog of queued requests
grew over the window, with the window's throughput and tails.

    python3 bench/tools/knee.py --workload <cell> --seed <n> \
        --rates 1.6,2.0,2.4 [--ramp 40] [--seconds 30] [--out FILE]

The knee is the highest rate whose backlog does not grow; the cell's
``rate_rps`` is set at about four fifths of it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--ramp", type=float, default=40.0)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import math
    import numpy as np
    from bench import core
    from bench.drivers import serve_open_loop as sol
    from bench.trace import Phases

    spec = core.load_cell(args.workload)
    t0 = time.perf_counter()
    s, dims, srv, pages, stream_at = sol.setup(spec, args.seed, args.device)
    print(f"[knee] set-up {time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        n = int(math.ceil(rate * (args.ramp + args.seconds))) + 8
        ol = sol.OpenLoop(srv, stream_at(rate, n), cap=int(s["span_cap"]),
                          phases=Phases(False), pages=pages)
        ol.drive(ramp=args.ramp, seconds=args.seconds, follow=0.0,
                 cuda=args.device == "cuda")
        ctx = sol._window_ctx(ol.recs, ol.w0, ol.w1, ol.snap0, ol.snap1,
                              dims)
        q = [(t, b) for t, b in ol.backlog if ol.w0 <= t <= ol.w1]
        ts = np.array([t for t, _ in q])
        bs = np.array([b for _, b in q], float)
        slope = float(np.polyfit(ts, bs, 1)[0]) if len(q) > 2 else 0.0
        c = ctx["counters"]
        win = ol.w1 - ol.w0
        row = {"rate_rps": rate, "window_s": win,
               "due": ctx["attempted"], "no_first_token": ctx["failed"],
               "backlog_start": int(bs[0]), "backlog_end": int(bs[-1]),
               "backlog_slope_per_s": slope,
               "gen_tok_s": ctx["window_tokens"] / win,
               "live_rows_mean": c["gen_tokens"] / max(c["decode_steps"], 1),
               "decode_step_ms": 1e3 * win / max(c["decode_steps"], 1),
               "ttft_p50_ms": core.nearest_rank(ctx["ttft_ms"], 0.5),
               "ttft_p90_ms": core.nearest_rank(ctx["ttft_ms"], 0.9),
               "ttft_p95_ms": core.nearest_rank(ctx["ttft_ms"], 0.95),
               "tpot_p90_ms": core.nearest_rank(ctx["tpot_ms"], 0.9),
               "tpot_p95_ms": core.nearest_rank(ctx["tpot_ms"], 0.95)}
        row["grew"] = bool(row["backlog_end"] > row["backlog_start"] + 2
                           and slope > 0.05)
        rows.append(row)
        print("[knee] " + json.dumps(row), flush=True)
        drain = srv.start_loop([])
        while drain.tick():
            pass
        srv.release_prefix_cache()
        # the documents back into the cache for the next rate
        from repro_torch.launch.serve import Request
        srv.run([Request(rid=sol.DOC_RID + d, prompt=doc.astype(np.int32),
                         max_new=1)
                 for d, doc in enumerate(stream_at(1.0, 1).docs)])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
