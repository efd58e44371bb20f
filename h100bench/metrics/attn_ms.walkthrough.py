"""Device time per frame of the port's ``panogrf.agg.attn`` spans in the
profiled sub-window: the ray attention (the position add, the attention,
fc, the residual and the LayerNorm) inside each aggregation."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.agg.attn")
