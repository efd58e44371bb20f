"""Device time per step of the port's ``panogrf.train.forward`` span in the
profiled sub-window: the MVS net's forward and the loss."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.train.forward")
