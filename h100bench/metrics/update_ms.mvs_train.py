"""Device time per step of the port's ``panogrf.train.update`` span in the
profiled sub-window: the element-wise clip and the Adam step."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.train.update")
