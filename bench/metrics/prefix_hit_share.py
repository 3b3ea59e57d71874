"""Prompt tokens served from the prefix cache over prompt tokens admitted
in the window (``serve.prefix_hit_tokens`` / ``serve.prefill_tokens``),
in %."""


def read(ctx):
    c = ctx.get("counters")
    if not c or not c.get("prefill_tokens"):
        return None
    return 100.0 * c["prefix_hit_tokens"] / c["prefill_tokens"]
