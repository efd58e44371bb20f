"""Kernels launched per frame in the profiled sub-window."""


def read(ctx):
    if not ctx.trace_items or not ctx.summary.launches:
        return None
    return ctx.summary.launches / ctx.trace_items
