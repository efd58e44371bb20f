"""Device time of ``prepare_ref_data`` per scene (CUDA events around each
call in the window)."""


def read(ctx):
    ms = ctx.spans.get("prepare_ref")
    return sum(ms) / len(ms) if ms else None
