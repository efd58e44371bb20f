"""Device time per frame of the port's ``panogrf.render.coarse`` span in the
profiled sub-window: the low-res coarse pass (every coarse chunk's gather
and aggregation included) and the upsample of its hit probability."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.render.coarse")
