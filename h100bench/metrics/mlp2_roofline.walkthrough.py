"""``mlp2``'s share of its roofline: the least bytes of its calls (rows
per call as the reference's calls of the same frames had them; each row
read once, each output written once, in the frame's compute dtype) over
the HBM rate, against the kernels' device time in the profiled
sub-window.  The bound is the bytes one: the MLP does 16 x 17 multiply-adds
a row on 34 bytes."""

from h100bench import roofline

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def read(ctx):
    n, seconds = ctx.summary.matching("mlp2")
    calls = getattr(ctx.driver, "mlp2_calls", None)
    if not n or not seconds or not calls:
        return None
    size = DTYPE_BYTES[ctx.cell.config["renderer"]["compute_dtype"]]
    per_call = sum(roofline.mlp2_bytes(*c, size) for c in calls) / len(calls)
    return 100.0 * n * per_call / roofline.PEAK_HBM_BYTES / seconds
