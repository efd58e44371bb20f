"""What the per-layer readers take from the port's own spans.

The port marks its layers with ``panogrf_tpu_torch/utils/spans.py``,
which records only while a profiler records: in a ``--trace 1`` run that
is the profiled sub-window alone, so the port's store holds that
sub-window's spans.  A span's device time is the time between its two
events on the stream, so it holds the card's idle time inside the span
too, which the profiler's own host cost lengthens where a layer is paced
by the host.  A program without that module, or whose spans never ran,
gives nothing to read: each function returns None, and raises nothing.
"""

from __future__ import annotations

PREFIX = "panogrf."


def _spans():
    try:
        from panogrf_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def ms_per_unit(ctx, name: str):
    """Device ms of the port's span ``name`` over the sub-window's units,
    or None where the span never ran."""
    spans = _spans()
    if spans is None or not ctx.trace_items:
        return None
    ms = spans.device_ms().get(name)
    return sum(ms) / ctx.trace_items if ms else None


def host_gap_ms_per_unit(ctx):
    """Device-idle ms per unit of the sub-window whose innermost host
    event is one of the port's spans (the host running the port's own
    Python between launches), or None where no span of the port ran."""
    spans = _spans()
    if spans is None or not ctx.trace_items or not spans.device_ms():
        return None
    s = sum(v for k, v in ctx.summary.idle_gaps.items()
            if k.startswith(PREFIX))
    return s * 1000.0 / ctx.trace_items
