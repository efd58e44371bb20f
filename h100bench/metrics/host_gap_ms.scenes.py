"""Device-idle time per unit of the profiled sub-window in which the
host's innermost event was one of the port's ``panogrf.*`` spans: the
card waiting on the port's own Python between launches."""

from h100bench import port_spans


def read(ctx):
    return port_spans.host_gap_ms_per_unit(ctx)
