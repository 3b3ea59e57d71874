"""Model FLOPs of the training steps run in the window (forward and
backward, 3x the forward's matmuls and causal attention,
``counts/decoder.py``) over the window at the bf16 peak, in %."""
from bench.counts import decoder, peaks


def read(ctx):
    if "train_steps" not in ctx:
        return None
    fl = ctx["train_steps"] * decoder.train_step_flops(
        ctx["dims"], rows=ctx["rows"], seq=ctx["seq"])
    return 100.0 * fl / (ctx["window_s"] * peaks.BF16_FLOPS)
