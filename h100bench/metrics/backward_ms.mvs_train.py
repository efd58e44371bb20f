"""Device time per step of the port's ``panogrf.train.backward`` span in the
profiled sub-window: ``loss.backward()``."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.train.backward")
