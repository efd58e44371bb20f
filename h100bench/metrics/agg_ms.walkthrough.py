"""Device time per frame of the port's ``panogrf.render.agg`` spans in the
profiled sub-window: the aggregation net of every coarse and fine chunk."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.render.agg")
