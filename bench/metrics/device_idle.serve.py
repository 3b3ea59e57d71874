"""Share of the traced slice of the serving window in which no operation
ran on the device (kineto's events), in %."""


def read(ctx):
    if not ctx.get("busy_s") or ctx.get("kind") == "train":
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["slice_s"])
