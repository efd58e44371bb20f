"""The ``cross_view_pool`` kernel's share of its roofline: the least bytes
of its calls over the HBM rate, against the kernels' device time in the
profiled sub-window.

The bytes of a call are its (ray, sample) points times the bytes of a
point: each view's 35 + 32 + 4 + 1 bf16 input channels read once (144 B
a view), the 16 + 3 + 1 bf16 outputs written once (40 B): 328 B at two
views, 472 B at three.  The points of a call and its views come from the
port's counters (``VARIANT_LAUNCHES``: ``pool_points`` over the fused
launches, and ``pool_fused_v2`` to ``_v4``), which the driver's
``counters`` gives.  The bytes bound the kernel: its multiply-adds take
~0.077 ms a call of 1,048,576 two-view points at the bf16 peak, its bytes
0.103 ms.  A program without those counters gives nothing to read."""

from h100bench import roofline

VIEW_BYTES = (35 + 32 + 4 + 1) * 2
OUT_BYTES = (16 + 3 + 1) * 2
VIEWS = (2, 3, 4)


def point_bytes(views: int) -> int:
    """The least bytes one (ray, sample) point of a ``views``-view pool
    moves."""
    return views * VIEW_BYTES + OUT_BYTES


def read(ctx):
    counters = getattr(ctx.driver, "counters", None)
    c = counters().get("mlp2_launches", {}) if counters else {}
    by_views = {v: c.get(f"pool_fused_v{v}", 0) for v in VIEWS}
    calls, points = sum(by_views.values()), c.get("pool_points", 0)
    n, seconds = ctx.summary.matching("cross_view_pool")
    if not calls or not points or not n or not seconds:
        return None
    per_point = sum(k * point_bytes(v) for v, k in by_views.items()) / calls
    per_call = points / calls * per_point
    return 100.0 * n * per_call / roofline.PEAK_HBM_BYTES / seconds
