"""The multi-view frame's aggregation FLOPs (the frozen roofline model at
as many views as the configuration has references: the coarse pass on
the (H/f, W/f) grid and the fine pass on every pixel) over the window's
time per frame, as a share of the bf16 peak."""

from h100bench import roofline


def read(ctx):
    cfg, r = ctx.cell.config, ctx.cell.config["renderer"]
    if "frame_ms" not in ctx.e2e or "refs" not in cfg:
        return None
    model = roofline.frame_model(
        cfg["height"], cfg["width"], r["depth_sample_num"],
        r["fine_depth_sample_num"], r["gather_stride"],
        r["gather_stride_fine"], v=len(cfg["refs"]),
        coarse_geometry_only=r["coarse_geometry_only"],
        lowres_coarse=cfg["coarse_lowres"], dtype=r["compute_dtype"])
    peak = roofline.PEAK_FLOPS[r["compute_dtype"]]
    return 100.0 * model["agg_flops"] / (ctx.e2e["frame_ms"] * 1e-3 * peak)
