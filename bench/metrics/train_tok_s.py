"""Tokens of the training steps run in the window over the window's
seconds, the window ending at the device sync after its last step."""


def read(ctx):
    if "train_tokens" not in ctx:
        return None
    return ctx["train_tokens"] / ctx["window_s"]
