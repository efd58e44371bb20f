"""The multi-view walkthrough (``drivers/mv_walkthrough.py``) at 64x128 on
the CPU: set-up through the multi-source stack, a unit, a sound run that
reads ``correct``, the control and two planted faults that read
``correct`` false, and the ``cross_view_pool`` roofline reader.

The faults are the ones this cell exists to catch: the depth stack swept
cyclically pairwise (one source a reference, ``stack_depth_for_sample``'s
default) and the pool fed two of the three references.  The same
contexts are planted in the card's full-size runs that set the limits.
With random weights the stack's depth lies below the renderer's near
bound, so the frames do not show the stack's fault: ``mvs_depth_gap``
does.
"""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from h100bench import manifest, roofline
from h100bench.calibrate import calibrate
from h100bench.run import run_cell
from h100bench.tests import tiny
from h100bench.trace import Summary

WORKLOAD = "genmv4.walkthrough"
# a seed whose random MVS head predicts positive depth over most pixels
# at this size (2**31 + 17 predicts 0 everywhere: the clamp leaves nothing
# a stack fault can move)
SEED = 2 ** 31 + 29
SMALL_MV = dict(tiny.SMALL["gen2v_512x1024"])
SMALL_TRAFFIC = dict(tiny.SMALL_TRAFFIC["walkthrough"])


@contextlib.contextmanager
def _patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def plant_pairwise_stack():
    """The port's stack sweeps each reference against the next reference
    alone, cyclically (refs [0, 1, 2] -> sources [1, 2, 0]), where it is
    given every other reference."""
    from panogrf_tpu_torch.models.depth_stack import DepthStack

    def make(orig):
        def forward(self, ref, src, rw, sw):
            if src.dim() != 5:
                return orig(self, ref, src, rw, sw)
            r = ref.shape[0]
            # the next reference's place among each reference's others
            pick = [(i + 1) % r - ((i + 1) % r > i) for i in range(r)]
            rows = torch.arange(r, device=src.device)
            pick = torch.as_tensor(pick, device=src.device)
            return orig(self, ref, src[rows, pick], rw, sw[rows, pick])
        return forward
    return _patched(DepthStack, "forward", make)


def plant_two_view_pool():
    """The aggregation net pools over the first two references only."""
    from panogrf_tpu_torch.renderer.agg_net import IBRNetWithNeuRay

    def make(orig):
        def forward(self, rgb_feat, neuray_feat, ray_diff, mask, *a, **k):
            ts = (rgb_feat, neuray_feat, ray_diff, mask)
            if rgb_feat.shape[2] > 2:
                ts = tuple(t[:, :, :2] for t in ts)
            return orig(self, *ts, *a, **k)
        return forward
    return _patched(IBRNetWithNeuRay, "forward", make)


FAULTS = {"pairwise_stack": plant_pairwise_stack,
          "two_view_pool": plant_two_view_pool}


@pytest.fixture
def cell(tmp_path, monkeypatch):
    monkeypatch.setitem(tiny.SMALL, "genmv4_512x1024", SMALL_MV)
    monkeypatch.setitem(tiny.SMALL_TRAFFIC, "mv_walkthrough", SMALL_TRAFFIC)
    return tiny.tiny_cell(WORKLOAD, tmp_path)


def test_setup_prepares_three_references_and_a_unit_renders(cell):
    drv = cell.driver().Driver(cell, SEED, "cpu", False)
    drv.setup()
    cfg = cell.config
    assert drv.x["src_imgs"].shape[:2] == (3, 2)
    assert drv.ref_data["w2c"].shape[0] == 3
    assert drv.stack_depth.shape == (3, *cfg["depth_hw"], 1)
    # the path's ends: the first reference and the held-out view
    c2w = drv.x["c2w"].cpu().numpy()
    assert (drv.ends == c2w[[0, 3]]).all()
    n = drv.run_unit()
    assert n == cell.traffic["frame_batch"] == drv.frames
    assert drv.counters()["frames"] == n


def test_sound_run_reads_correct(cell):
    res = run_cell(cell, SEED, 1.0, False, device="cpu")
    assert set(res["check"]) == {"frame_mae", "frame_bad_px",
                                 "mvs_depth_gap"}
    assert res["correct"] is True, res["check"]
    assert res["readings"]["mvs_depth_gap"] <= 1e-6


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_reads_incorrect(cell, fault):
    with FAULTS[fault]():
        res = run_cell(cell, SEED, 1.0, False, device="cpu")
    assert res["correct"] is False, res["check"]
    if fault == "pairwise_stack":
        assert res["readings"]["mvs_depth_gap"] > \
            cell.traffic["limits"]["mvs_depth_gap"], res["check"]
    if fault == "two_view_pool":
        # the stack is sound: the frames alone show this fault
        assert res["readings"]["mvs_depth_gap"] <= 1e-6
        assert res["readings"]["frame_mae"] > \
            cell.traffic["limits"]["frame_mae"], res["check"]


def test_control_fails_the_check(cell):
    rec = calibrate(cell, [2 ** 31 + 29], 1.0, control="fp8",
                    control_runs=1, device="cpu", out=lambda s: None)[0]
    limits = cell.traffic["limits"]
    over = [n for n, lim in limits.items()
            if rec["control"]["readings"][n] > lim]
    assert over, (rec["control"]["readings"], limits)


def test_cross_view_pool_roofline_reader():
    """Points a call from the counters, bytes a point from the views
    (328 B at two, 472 B at three), the kernels' time from the trace; none
    without the counters (a program before them) or without kernels."""
    read = manifest.reader("cross_view_pool_roofline.walkthrough")
    points = 4 * 4096 * 64
    for views, per_point in ((2, 328), (3, 472)):
        counters = {f"pool_fused_v{views}": 160, "pool_fused": 160,
                    "pool_points": 160 * points}
        drv = SimpleNamespace(counters=lambda c=counters: {
            "mlp2_launches": c, "frames": 4})
        seconds = 2 * points * per_point / roofline.PEAK_HBM_BYTES
        s = Summary(window_s=1.0, busy_s=0.5, launches=10,
                    kernel_s={f"void cross_view_pool_kernel<{views}>(...)":
                              seconds},
                    kernel_n={f"void cross_view_pool_kernel<{views}>(...)":
                              4})
        ctx = SimpleNamespace(driver=drv, summary=s)
        assert read(ctx) == pytest.approx(200.0)
    drv.counters = lambda: {"mlp2_launches": {"pool_fused": 160,
                                              "pool_plain": 0}}
    assert read(SimpleNamespace(driver=drv, summary=s)) is None
    assert read(SimpleNamespace(driver=SimpleNamespace(), summary=s)) is None
    empty = Summary(window_s=1.0, busy_s=0.5, launches=10)
    assert read(SimpleNamespace(driver=SimpleNamespace(
        counters=lambda: {"mlp2_launches": counters}), summary=empty)) \
        is None


def test_frame_mfu_reader_counts_every_reference():
    """The multi-view frame's FLOPs are the roofline model's at as many
    views as the configuration has references (three), more than the
    two-view reader counts for the same frame; none without ``frame_ms``."""
    cell = manifest.Cell(WORKLOAD)
    cfg, r = cell.config, cell.config["renderer"]
    read = manifest.reader("frame_mfu.mv_walkthrough")
    ctx = SimpleNamespace(cell=cell, e2e={"frame_ms": 552.0})
    model = roofline.frame_model(
        cfg["height"], cfg["width"], r["depth_sample_num"],
        r["fine_depth_sample_num"], r["gather_stride"],
        r["gather_stride_fine"], v=3,
        coarse_geometry_only=r["coarse_geometry_only"],
        lowres_coarse=cfg["coarse_lowres"], dtype=r["compute_dtype"])
    peak = roofline.PEAK_FLOPS[r["compute_dtype"]]
    assert read(ctx) == pytest.approx(
        100.0 * model["agg_flops"] / (0.552 * peak))
    assert read(ctx) > manifest.reader("frame_mfu.walkthrough")(ctx)
    assert read(SimpleNamespace(cell=cell, e2e={})) is None
