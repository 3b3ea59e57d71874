"""Nearest-rank 95th percentile, over requests with at least two tokens
in the window, of each one's mean gap between its window tokens (host
clock)."""
from bench.core import nearest_rank


def read(ctx):
    if not ctx.get("tpot_ms"):
        return None
    return nearest_rank(ctx["tpot_ms"], 0.95)
