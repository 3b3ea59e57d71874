"""Window seconds over the decode steps the server ran in it (host
clock; admissions' prefill forwards fall between steps and count)."""


def read(ctx):
    c = ctx.get("counters")
    if not c or not c.get("decode_steps"):
        return None
    return 1e3 * ctx["window_s"] / c["decode_steps"]
