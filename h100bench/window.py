"""The arithmetic of a measured window.

A rate is taken over all the work and all the time of the window; a tail
over every unit in it.
"""

from __future__ import annotations

import math


def ms_per_unit(seconds: float, units: int) -> float:
    """The window's wall time over the units it completed, in ms."""
    if units <= 0:
        raise ValueError("the window completed no unit")
    return seconds * 1000.0 / units


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of every value (q in (0, 100])."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]
