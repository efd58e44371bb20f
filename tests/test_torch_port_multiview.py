"""The multi-view model on the port's serving path: the multi-source depth
stack against the plain reference (``h100bench/reference/depth_mv.py``),
a 3-reference frame against the frozen reference renderer, the render_mv
CLI's stack and serving flags, and the pool's counters by view count.

The reference and the scene come from ``h100bench`` (plain PyTorch; they
import nothing of the port or of JAX).  The nets carry the benchmark's
seeded random weights (``h100bench/weights.py``) at 64x128, depth 32x64,
8 hypotheses, float32 on the CPU.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from h100bench import scenes_mv
from h100bench.drivers.common import relative_gap, seeds
from h100bench.drivers.gen2v import Program
from h100bench.drivers.mv_walkthrough import MVReference
from h100bench.reference.depth_mv import stack_forward_mv
from h100bench.reference.renderer import full_render as ref_full_render
from panogrf_tpu_torch.models.depth_stack import (other_refs, run_mono,
                                                  stack_depth_for_sample)
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.ops.kernels import _build
from panogrf_tpu_torch.ops.kernels import cross_view_pool as cvp
from panogrf_tpu_torch.ops.kernels import fused_mlp
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.tools import render_mv
from panogrf_tpu_torch.utils import spans
from torch_port_threads import one_torch_thread  # noqa: F401

# a seed whose random MVS head predicts positive depth over most pixels;
# where it predicts none, the clamp at 0 leaves nothing a stack fault can
# move (seed 2**31 + 17 predicts 0 everywhere at this size)
SEED = 2 ** 31 + 29
CFG = {
    "height": 64, "width": 128, "depth_hw": [32, 64], "mono_hw": [64, 128],
    "m3d_dist": 0.25, "views": 4, "refs": [0, 1, 2], "query": 3,
    "render_depth_range": [0.5, 15.0], "coarse_lowres": 2, "coarse_chunk": 0,
    "renderer": {"depth_sample_num": 16, "fine_depth_sample_num": 16,
                 "fast_gather": True, "compute_dtype": "float32",
                 "gather_depth_major": True, "gather_stride": 4,
                 "gather_stride_fine": 16, "decode_on_map": True,
                 "coarse_geometry_only": True},
    "mono": {"max_depth": 10.0, "fusion_type": "cee", "se_in_fusion": True,
             "num_layers": 18},
    "mvs": {"min_depth": 0.1, "max_depth": 10.0, "num_hypotheses": 8,
            "magnet_num_samples": 5, "fixed_sigma": 0.5, "wrap": True,
            "cnn3d_base": 32},
}
CPU = torch.device("cpu")
# Port and reference run the same float32 operations on the CPU; the
# stack's batch layout differs (the port resizes every source in one
# call), which may reorder a float32 sum: 1e-5 of the largest depth.  The
# pairwise stack moves the depth by ~1e-2 of it at this seed.
DEPTH_TOL = 1e-5
# The frames: a float32 chain of ~40 layers a sample, composited over 32
# samples, in two implementations whose sums may associate differently:
# 1e-4 of the [0, 1] colour range (a bfloat16 step is 4e-3).
FRAME_TOL = 1e-4


@pytest.fixture(scope="module")
def scene():
    s = seeds(SEED, 7)
    program = Program(CFG, s[:3], CPU)
    ref = MVReference(CFG, program.shapes, s[:3], CPU)
    sample = scenes_mv.multi_view(s[3], s[4], CFG["height"], CFG["width"],
                                  CFG["m3d_dist"], CFG["views"], CPU)
    x = scenes_mv.scene_inputs(sample, CFG["refs"], CFG["query"])
    return SimpleNamespace(program=program, ref=ref, sample=sample, x=x)


def _reference_depth(scene):
    x = scene.x
    return stack_forward_mv(scene.ref.mono, scene.ref.mvs, x["ref_imgs"],
                            x["src_imgs"], x["ref_w2c"], x["src_w2c"],
                            tuple(CFG["mono_hw"]), tuple(CFG["depth_hw"]))


def test_other_refs_sweeps_each_reference_against_the_rest():
    assert other_refs([0, 1, 2]) == [[1, 2], [0, 2], [0, 1]]
    assert other_refs([0, 2]) == [[2], [0]]
    assert scenes_mv.other_refs([0, 1, 2]) == other_refs([0, 1, 2])


def test_multi_source_stack_matches_the_reference(scene):
    """Each reference swept against the other two: the port's depth and
    prior within ``DEPTH_TOL`` of the plain reference's; the cyclic
    pairwise stack (one source a reference) is not."""
    want = _reference_depth(scene)
    got = stack_depth_for_sample(scene.program.stack, scene.sample,
                                 CFG["refs"], other_refs(CFG["refs"]))
    assert float(want["mvs_depth"].max()) > 0
    for k in ("mvs_depth", "mono_depth"):
        assert got[k].shape == want[k].shape
        assert relative_gap(got[k], want[k]) <= DEPTH_TOL, k
    pairwise = stack_depth_for_sample(scene.program.stack, scene.sample,
                                      CFG["refs"])
    assert relative_gap(pairwise["mvs_depth"], want["mvs_depth"]) \
        > 100 * DEPTH_TOL


def test_one_source_is_the_two_view_path_exactly(scene):
    """(rfn, H, W, 3) and (rfn, 1, H, W, 3) sources both give, bit for
    bit, the two-view stack: the MVS net on each (source, reference) pair
    stacked with the source first."""
    x, stack = scene.x, scene.program.stack
    ref, rw = x["ref_imgs"][:2], x["ref_w2c"][:2]
    src, sw = x["src_imgs"][:2, 0], x["src_w2c"][:2, 0]
    dhw = tuple(CFG["depth_hw"])
    with torch.inference_mode():
        mono = run_mono(stack.mono_model, ref, stack.mono_hw)
        panos = torch.stack([resize_linear(src, dhw, axes=(1, 2)),
                             resize_linear(ref, dhw, axes=(1, 2))], 1)
        rots = torch.stack([sw[:, :, :3], rw[:, :, :3]], 1)
        trans = torch.stack([sw[:, :, 3], rw[:, :, 3]], 1)
        out = stack.mvs_model(panos, rots, trans, mono["pred_depth"],
                              mono.get("mono_feat"))
    want = {"mvs_depth": torch.clamp(out["depth"], min=0.0),
            "mono_depth": mono["pred_depth"]}
    if "pred_final" in out:
        want["mvs_uncert"] = out["pred_final"][..., 1:]
    for got in (stack(ref, src, rw, sw),
                stack(ref, src[:, None], rw, sw[:, None])):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_three_reference_frame_matches_the_reference_renderer(scene):
    """The scene prepared by the port (multi-source stack, then
    ``prepare_ref_data``) and by the frozen copies; frames of the path
    toward the held-out view through ``render_video_device``."""
    x = scene.x
    depth = scene.program.depth(x)["mvs_depth"]
    ref_data = scene.program.prepare(x, depth)
    assert ref_data["w2c"].shape[0] == 3
    want_scene = scene.ref.scene(x)
    c2w = x["c2w"].numpy()
    poses = np.stack([c2w[0], c2w[3]])
    qdr = torch.tensor([CFG["render_depth_range"]])
    rdr = qdr.expand(3, 2).contiguous()
    kw = dict(chunk=2048, coarse_lowres=CFG["coarse_lowres"],
              coarse_chunk=0, device=CPU)
    got = full_render.render_video_device(scene.program.renderer, ref_data,
                                          poses, qdr, rdr, **kw)
    want = ref_full_render.render_video_device(
        scene.ref.renderer, want_scene["ref_data"], poses, qdr, rdr, **kw)
    assert got.shape == (2, CFG["height"], CFG["width"], 3)
    assert float((got - want).abs().max()) <= FRAME_TOL


def test_sweep_span_notes_the_sources(scene, monkeypatch):
    """Under a profiler, ``panogrf.mvs.sweep`` gives its range the number
    of sources each reference was swept against."""
    x, stack = scene.x, scene.program.stack
    record = torch.profiler.record_function
    notes = []

    def spy(name, args=None):
        if name == "panogrf.mvs.sweep":
            notes.append(args)
        return record(name, args)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with profile(activities=[ProfilerActivity.CPU]):
        stack(x["ref_imgs"], x["src_imgs"], x["ref_w2c"], x["src_w2c"])
        stack(x["ref_imgs"], x["src_imgs"][:, 0], x["ref_w2c"],
              x["src_w2c"][:, 0])
    spans.reset()
    assert notes == ["sources=2", "sources=1"]


def test_render_mv_cli_serves_from_the_multi_source_stack(tmp_path,
                                                          monkeypatch):
    """``--depth-stack --preset serving``: the stack sweeps each reference
    against the other two, no true depth is read (it is NaN here), and a
    2-pose pass toward the query is drawn and written."""
    made = render_mv.make_multi_view_sample

    def no_depth(*a, **k):
        s = made(*a, **k)
        return {**s, "depth_panos": torch.full_like(s["depth_panos"],
                                                    float("nan"))}
    monkeypatch.setattr(render_mv, "make_multi_view_sample", no_depth)
    sweeps = []
    stack_fn = render_mv.stack_depth_for_sample

    def spy(stack, sample, ref_ids, src_ids=None):
        sweeps.append(src_ids)
        return stack_fn(stack, sample, ref_ids, src_ids)
    monkeypatch.setattr(render_mv, "stack_depth_for_sample", spy)
    out = tmp_path / "out"
    summary = render_mv.main([
        "--num", "1", "--views", "4", "--que-idx", "3", "--height", "32",
        "--width", "64", "--depth-height", "32", "--depth-width", "64",
        "--depth-stack", "--preset", "serving", "--frame-batch", "2",
        "--device", "cpu", "--out", str(out)])
    assert sweeps == [[[1, 2], [0, 2], [0, 1]]]
    assert summary["depth_stack"]["sources"] == sweeps[0]
    assert len(summary["stack_seconds"]) == 1
    stems = {p.name.split(".")[0] for p in out.iterdir()}
    assert {"0-frame000", "0-frame001", "0-nr_fine", "0-gt",
            "metric"} <= stems
    assert all(np.isfinite(v) for v in summary["mean"].values())


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the kernel's
    wrapper on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("views", [2, 3, 4])
def test_pool_counters_count_launches_by_views_and_points(views,
                                                         monkeypatch):
    """One launch adds one to ``pool_fused`` and ``pool_fused_v<V>`` and
    its N points to ``pool_points``: host integers from the shapes."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: empty(*a, **k))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "load_library", lambda: SimpleNamespace(
        panogrf_cross_view_pool=lambda *a: 0))
    n = 96
    ins = [torch.Tensor._make_subclass(
        _LooksCuda, torch.zeros(n, views, c, dtype=torch.bfloat16))
        for c in (cvp.F, cvp.ND, cvp.RD, 1)]
    packed = torch.Tensor._make_subclass(
        _LooksCuda, torch.zeros(cvp.PACKED_SIZE, dtype=torch.bfloat16))
    fused_mlp.reset_launches()
    for _ in range(2):
        cvp.cross_view_pool(*ins, packed)
    got = dict(fused_mlp.VARIANT_LAUNCHES)
    fused_mlp.reset_launches()
    assert got["pool_fused"] == got[f"pool_fused_v{views}"] == 2
    assert got["pool_points"] == 2 * n
    assert got["pool_plain"] == 0
    assert sum(got[f"pool_fused_v{v}"] for v in (2, 3, 4)) == 2


@pytest.mark.card
def test_three_references_pool_in_the_v3_kernel_on_the_card():
    """On the card, a bfloat16 serving pass over three references pools
    in the V = 3 kernel every call, and never in the plain chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = dict(CFG, renderer=dict(CFG["renderer"], compute_dtype="bfloat16"))
    s = seeds(SEED, 7)
    program = Program(cfg, s[:3], dev)
    sample = scenes_mv.multi_view(s[3], s[4], cfg["height"], cfg["width"],
                                  cfg["m3d_dist"], cfg["views"], dev)
    x = scenes_mv.scene_inputs(sample, cfg["refs"], cfg["query"])
    ref_data = program.prepare(x, program.depth(x)["mvs_depth"])
    qdr = torch.tensor([cfg["render_depth_range"]], device=dev)
    poses = x["c2w"][[0, 3]].cpu().numpy()
    fused_mlp.reset_launches()
    rgb = full_render.render_video_device(
        program.renderer, ref_data, poses, qdr, qdr.expand(3, 2), chunk=2048,
        coarse_lowres=2, device=dev)
    got = dict(fused_mlp.VARIANT_LAUNCHES)
    assert bool(torch.isfinite(rgb).all())
    assert got["pool_fused_v3"] == got["pool_fused"] > 0
    assert got["pool_plain"] == got["pool_fused_v2"] == 0
