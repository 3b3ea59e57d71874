"""Process start to window start (host clock): kernels, weights, warm-up,
the prefix cache's documents and the ramp, or the first steps."""


def read(ctx):
    return ctx.get("setup_s")
