"""Share of the profiled sub-window in which no kernel, copy or memset
ran on the device."""


def read(ctx):
    if ctx.summary.window_s <= 0:
        return None
    return 100.0 * ctx.summary.idle_share
