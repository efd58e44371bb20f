"""Device time per scene of the port's ``panogrf.mvs.reg`` span in the
profiled sub-window: the MVS net's 3D regularisation (UNet3D)."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.mvs.reg")
