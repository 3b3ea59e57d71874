"""Nearest-rank 95th percentile, over every request due in the window, of
its due time to its first token (host clock); a request that failed or
never answered counts as missing (above any time). Read in the traced
run's window, which carries no profiler (its slice follows the window):
the time to first token is a per-layer reading of the serving cell, since
its host-clock tail spreads too widely between runs to hold a bound."""
import math

from bench.core import nearest_rank


def read(ctx):
    if "ttft_ms" not in ctx or not ctx["ttft_ms"]:
        return None
    v = nearest_rank(ctx["ttft_ms"], 0.95)
    # a missing request at the percentile: the longest it was followed
    return v if math.isfinite(v) else ctx["follow_ms"]
