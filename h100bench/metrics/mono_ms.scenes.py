"""Device time per scene of the port's ``panogrf.mono`` span in the profiled
sub-window: UniFuse inside the depth stack."""

from h100bench import port_spans


def read(ctx):
    return port_spans.ms_per_unit(ctx, "panogrf.mono")
