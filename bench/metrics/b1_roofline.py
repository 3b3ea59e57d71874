"""Kernel B1's share of its roofline in the traced slice, in %: the
bound of each recorded call (the larger of its bytes at the HBM rate and
its FLOPs at the bf16 peak, ``counts/paged_attention.py``) summed, over
the summed device time of ``paged_attn*`` and ``merge_partials*``
kernels in the slice."""
from bench.counts import peaks


def read(ctx):
    if not ctx.get("b1_device_s") or not ctx.get("b1_calls"):
        return None
    bound = max(ctx["b1_bytes"] / peaks.HBM_BYTES,
                ctx["b1_flops"] / peaks.BF16_FLOPS)
    return 100.0 * bound / ctx["b1_device_s"]
