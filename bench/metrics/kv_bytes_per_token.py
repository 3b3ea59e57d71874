"""Paged-pool bytes in use (pages taken, scales included, prefix-cache
pages too) over the context tokens the live rows hold, at the window's
end: quantization and page sharing both lower it."""


def read(ctx):
    h = ctx.get("held")
    if not h or not h["tokens"]:
        return None
    return h["bytes"] / h["tokens"]
