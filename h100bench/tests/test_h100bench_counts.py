"""The FLOP and byte counts, the weights drawn from a seed, and the
readers that turn them into shares of a peak."""

from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from h100bench import manifest, roofline, weights
from h100bench.drivers.common import count_flops
from h100bench.trace import Summary


def test_mlp2_bytes_reads_each_row_once():
    rows = 4 * 4096 * 64
    assert roofline.mlp2_bytes(rows, 16, 16, 1, 2) == \
        (rows * 17 + 16 * 16 + 16 + 16 + 1) * 2
    # the bound of the (16384, 16) -> 16 -> 1 bf16 call: 0.1665 us
    assert roofline.mlp2_bytes(16384, 16, 16, 1, 2) \
        / roofline.PEAK_HBM_BYTES == pytest.approx(0.1665e-6, rel=1e-3)


def test_frame_model_is_frozen():
    m = roofline.frame_model(512, 1024, lowres_coarse=2)
    assert m["agg_flops"] == 3657164652544
    coarse = roofline.agg_stage(256 * 512, 64, geometry_only=True).flops
    fine = roofline.agg_stage(512 * 1024, 64).flops
    assert m["agg_flops"] == coarse + fine


def test_flop_counter_counts_a_convolution():
    x, w = torch.randn(2, 3, 8, 8), torch.randn(4, 3, 3, 3)
    _, flops = count_flops(lambda: F.conv2d(x, w, padding=1))
    assert flops == 2 * 2 * 4 * 8 * 8 * 3 * 9
    _, flops = count_flops(lambda: torch.randn(5, 6) @ torch.randn(6, 7))
    assert flops == 2 * 5 * 6 * 7


def test_weights_from_a_seed():
    m = torch.nn.Sequential(torch.nn.Conv2d(16, 32, 3), torch.nn.LayerNorm(8),
                            torch.nn.Linear(400, 300))
    shapes = weights.spec(m)
    a, b = weights.draw(shapes, 5, "cpu"), weights.draw(shapes, 5, "cpu")
    c = weights.draw(shapes, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["0.weight"], c["0.weight"])
    assert float(a["0.weight"].std()) == pytest.approx(1 / 144 ** 0.5,
                                                       rel=0.05)
    assert float(a["2.weight"].std()) == pytest.approx(1 / 400 ** 0.5,
                                                       rel=0.05)
    assert torch.equal(a["1.weight"], torch.ones(8))
    assert torch.equal(a["0.bias"], torch.zeros(32))
    weights.load(m, a)
    assert torch.equal(m[2].weight, a["2.weight"])
    with pytest.raises(KeyError):
        weights.load(m, {k: v for k, v in a.items() if k != "0.bias"})


def _cell(workload):
    return manifest.Cell(workload)


def test_frame_mfu_and_mlp2_roofline_readers():
    cell = _cell("gen2v.walkthrough")
    ctx = SimpleNamespace(cell=cell, e2e={"frame_ms": 1000.0})
    mfu = manifest.reader("frame_mfu.walkthrough")(ctx)
    assert mfu == pytest.approx(100 * 3657164652544 / 989e12)
    rows = 4 * 4096 * 64
    per_call = roofline.mlp2_bytes(rows, 16, 16, 1, 2)
    s = Summary(window_s=1.0, busy_s=0.5, launches=10,
                kernel_s={"mlp2_lanes_kernel<16>": 2 * per_call / 3.35e12},
                kernel_n={"mlp2_lanes_kernel<16>": 4})
    ctx = SimpleNamespace(cell=cell, summary=s,
                          driver=SimpleNamespace(
                              mlp2_calls=[(rows, 16, 16, 1)] * 3))
    assert manifest.reader("mlp2_roofline.walkthrough")(ctx) == \
        pytest.approx(200.0)
    ctx.driver.mlp2_calls = None                # nothing to read: no number
    assert manifest.reader("mlp2_roofline.walkthrough")(ctx) is None


def test_step_and_scene_mfu_readers():
    for metric, e2e in (("train_mfu.mvs_train", {"step_ms": 250.0}),
                        ("scene_mfu.scenes", {"scene_ms": 250.0})):
        ctx = SimpleNamespace(driver=SimpleNamespace(flops_per_item=67e11),
                              e2e=e2e)
        assert manifest.reader(metric)(ctx) == pytest.approx(40.0)
        ctx.driver.flops_per_item = None
        assert manifest.reader(metric)(ctx) is None
