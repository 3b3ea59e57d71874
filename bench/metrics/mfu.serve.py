"""Model FLOPs of the tokens served in the traced slice over the device's
busy seconds in it at the bf16 peak, in %: each decode token's matmuls
(head included) and attention over its context, each forwarded prompt
token's matmuls and attention (``counts/decoder.py``); idle rows and
cached prompt tokens count nothing. Below the knee the window's FLOPs
are the offered load's, so the share is taken over the time the device
worked: faster kernels raise it, a host that keeps the device waiting
does not lower it (``device_idle.serve`` reads that)."""
from bench.counts import decoder, peaks


def read(ctx):
    w = ctx.get("slice_work")
    if not w or not ctx.get("busy_s"):
        return None
    d = ctx["dims"]
    fl = (decoder.forward_flops(d, tokens=w["decode_tokens"],
                                keys=w["decode_keys"], head=True)
          + decoder.forward_flops(d, tokens=w["prefill_tokens"],
                                  keys=w["prefill_keys"], head=False))
    return 100.0 * fl / (ctx["busy_s"] * peaks.BF16_FLOPS)
