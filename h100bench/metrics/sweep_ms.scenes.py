"""Device time per scene of the port's ``panogrf.mvs.sweep`` span in the
profiled sub-window: the MVS net's depth hypotheses and spherical sweep."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.mvs.sweep")
