"""Device time per frame of the port's ``panogrf.agg.pool`` spans in the
profiled sub-window: the cross-view pool (``pool_reference``) inside
each aggregation."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.agg.pool")
