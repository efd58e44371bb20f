"""FLOPs of one step as the reference counts them (the prior's forward,
the MVS net's forward and backward, under ``torch.utils.flop_counter``)
over the window's time per step, as a share of the float32 peak."""

from h100bench import roofline


def read(ctx):
    flops = ctx.driver.flops_per_item
    if not flops or "step_ms" not in ctx.e2e:
        return None
    return 100.0 * flops / (ctx.e2e["step_ms"] * 1e-3
                            * roofline.PEAK_FLOPS["float32"])
