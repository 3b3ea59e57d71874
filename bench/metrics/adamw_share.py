"""The optimizer's share of a training step, in %: CUDA events around the
``adamw_update`` call over the whole step, in a few instrumented steps
after the window, each begun after a device sync."""


def read(ctx):
    if not ctx.get("adamw_step_s"):
        return None
    return 100.0 * ctx["adamw_s"] / ctx["adamw_step_s"]
