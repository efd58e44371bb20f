"""Device time of the frozen prior per step (CUDA events around each call
in the window)."""


def read(ctx):
    ms = ctx.spans.get("mono_prior")
    return sum(ms) / len(ms) if ms else None
