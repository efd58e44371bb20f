"""Device time of ``DepthStack.forward`` per scene (CUDA events around
each call in the window)."""


def read(ctx):
    ms = ctx.spans.get("stack")
    return sum(ms) / len(ms) if ms else None
