"""The composed serving path of the port against the JAX package, on the
CPU in float32: the frozen depth stack predicts the reference views'
depth, ``prepare_ref`` encodes them and ``render_image`` renders the query
view; ``render_video_device`` renders a pose path in frame batches; the
poses, the image metrics, the render CLI and the training CLI's
validation.

32x64 frames with 32 coarse + 32 fine samples and a 32x64 depth grid (as
``tests/test_torch_port_render.py``), the stack at mono 64x128 and MVS
32x64 with 8 hypotheses (as ``tests/test_torch_port_depth.py``).  Weights
are seeded in the port and carried to the JAX modules by the JAX
package's converters.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panogrf_tpu.data import imgs_info as jinfo
from panogrf_tpu.data import shards as jshards
from panogrf_tpu.data import synthetic as jsyn
from panogrf_tpu.models import depth_stack as jds
from panogrf_tpu.models import mvs as jmvs
from panogrf_tpu.models.unifuse import UniFuse as JUniFuse
from panogrf_tpu.renderer import full_render as jfr
from panogrf_tpu.renderer import poses as jposes
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu.train import metrics as jmetrics
from panogrf_tpu.utils import torch_convert as tcv
from panogrf_tpu_torch.data import imgs_info as tinfo
from panogrf_tpu_torch.models import depth_stack as tds
from panogrf_tpu_torch.models import mvs as tmvs
from panogrf_tpu_torch.models.unifuse import UniFuse as TUniFuse
from panogrf_tpu_torch.nn.blocks import init_parameters_
from panogrf_tpu_torch.renderer import full_render as tfr
from panogrf_tpu_torch.renderer import poses as tposes
from panogrf_tpu_torch.renderer.presets import preset_kwargs
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.tools import render as trender
from panogrf_tpu_torch.tools import train_renderer as tcli
from panogrf_tpu_torch.train import metrics as tmetrics
from torch_port_threads import one_torch_thread  # noqa: F401

H, W, DH, DW, DN = 32, 64, 32, 64, 32
MH, MW = 64, 128
MVS_KW = {"num_hypotheses": 8, "magnet_num_samples": 3, "cnn3d_base": 8}
# The fine depths are an inverse CDF of the coarse hit probability, which
# amplifies ulp-level differences of the coarse pass (as in
# test_torch_port_render.py): measured 5.0e-5 on rgb and 6.1e-4 of 7.2 on
# the rendered depth; the bounds leave room for other BLAS builds
RGB_ATOL = 1e-3
DEPTH_REL = 5e-4
# a B-frame pass against B one-frame passes: the same arithmetic in other
# batch shapes, so only float summation order may differ (measured 0)
VIDEO_ATOL = 1e-5


def numpy_sd(module: torch.nn.Module) -> dict:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def seeded(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    init_parameters_(module, torch.Generator().manual_seed(seed))
    return module.eval()


@pytest.fixture(scope="module")
def scene():
    """A synthetic three-view sample in both packages, and each package's
    depth stack with the same seeded weights."""
    js = dict(jsyn.make_three_view_sample(jsyn.SphereScene.random(31), H, W,
                                          m3d_dist=0.5, seed=4))
    # the procedural views sit on one line along their shared z axis, so
    # each lies on the others' longitude seam (x = 0, z < 0), where the
    # projection's pixel x is 0 or W - 1 by the sign of a rounding error
    # (ROADMAP, Queue 3); moving them off that line keeps the samples off
    # the seams
    js["trans"] = np.asarray(js["trans"]) + np.asarray(
        [[0.11, -0.04, 0.0], [-0.07, 0.05, 0.0], [0.03, 0.09, 0.0]],
        np.float32)
    ts = {k: torch.tensor(np.asarray(v)) for k, v in js.items()}
    mono = seeded(TUniFuse(), 30)
    mvs = seeded(tmvs.MVSDepthModel(**MVS_KW), 31)
    # the depth head ends in max(x, 0): a positive last bias puts random
    # weights' depth in the scene's range instead of near 0
    with torch.no_grad():
        mvs.decoders2[2].conv2.bias.fill_(3.0)
    tstack = tds.DepthStack(mono, mvs, (MH, MW), (DH, DW))
    jstack = jds.DepthStack(JUniFuse(), tcv.convert_unifuse(numpy_sd(mono)),
                            jmvs.MVSDepthModel(**MVS_KW),
                            tcv.convert_mvs(numpy_sd(mvs)), (MH, MW),
                            (DH, DW))
    return js, ts, tstack, jstack


def _port_renderer(preset: str, seed: int = 0) -> TR:
    return TR(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
              fine_depth_sample_num=DN,
              **preset_kwargs(preset, compute_dtype="float32"), device="cpu",
              generator=torch.Generator().manual_seed(seed)).eval()


def test_stack_to_frame_matches_jax(scene):
    """Stack depth -> prepare_ref -> render_image: the predicted depth,
    the frame and its depth agree with the JAX package's."""
    js, ts, tstack, jstack = scene
    pred_j = jds.stack_depth_for_sample(jstack.jitted(), js, jinfo.REF_IDS,
                                        jinfo.SRC_IDS)
    pred_t = tds.stack_depth_for_sample(tstack, ts, tinfo.REF_IDS,
                                        tinfo.SRC_IDS)
    want_depth = np.asarray(pred_j["mvs_depth"])
    np.testing.assert_allclose(pred_t["mvs_depth"].numpy(), want_depth,
                               atol=1e-5 * np.abs(want_depth).max())

    tm = _port_renderer("exact")
    params = tcv.convert_renderer(numpy_sd(tm))
    coords = jinfo.sample_train_coords(np.random.default_rng(0), H, W, 8)
    jdata = jinfo.build_render_sample(js, coords)
    jref = jdata["ref_imgs_info"]
    jref["mvs_depth"] = pred_j["mvs_depth"]
    jm = JR(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
            fine_depth_sample_num=DN)
    want = jfr.render_image(jm, params, jref, jdata["que_imgs_info"]["c2w"],
                            jdata["que_imgs_info"]["depth_range"],
                            chunk=H * W)

    tdata = tinfo.build_render_sample(ts, torch.tensor(np.asarray(coords)))
    tref = tdata["ref_imgs_info"]
    tref["mvs_depth"] = pred_t["mvs_depth"]
    got = tfr.render_image(tm, tref, tdata["que_imgs_info"]["c2w"],
                           tdata["que_imgs_info"]["depth_range"],
                           chunk=H * W, device="cpu")
    assert got["rgb"].shape == (H, W, 3) and got["depth"].shape == (H, W)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]),
                               atol=RGB_ATOL, rtol=0)
    want_d = np.asarray(want["depth"])
    np.testing.assert_allclose(got["depth"].numpy(), want_d, rtol=0,
                               atol=DEPTH_REL * np.abs(want_d).max())
    # a chunk that does not divide the frame pads the last chunk
    padded = tfr.render_image(tm, tref, tdata["que_imgs_info"]["c2w"],
                              tdata["que_imgs_info"]["depth_range"],
                              chunk=600, device="cpu")
    np.testing.assert_allclose(padded["rgb"].numpy(), got["rgb"].numpy(),
                               atol=1e-5)


@pytest.mark.parametrize("preset,clr", [("exact", 1), ("serving", 2)])
def test_video_matches_per_frame(scene, preset, clr):
    """render_video_device at B = 3 against render_image_device for each
    pose of the path."""
    _, ts, tstack, _ = scene
    tm = _port_renderer(preset, seed=1)
    data = tinfo.build_render_sample(ts, tinfo.full_image_coords(H, W))
    ref_info = data["ref_imgs_info"]
    ref_info["mvs_depth"] = tds.stack_depth_for_sample(
        tstack, ts, tinfo.REF_IDS)["mvs_depth"]
    c2w = tinfo.c2w_from_w2c(tinfo.pose_w2c(ts["rots"], ts["trans"])) \
        .numpy()
    # from the query view towards a point off the reference views' seams
    end = c2w[0].copy()
    end[:, 3] += [0.06, 0.02, 0.1]
    path = tposes.interpolate_c2w(c2w[1], end, 3)
    ref = tfr.prepare_ref_data(tm, ref_info, device="cpu")
    args = (data["que_imgs_info"]["depth_range"], ref_info["depth_range"])
    video = tfr.render_video_device(tm, ref, path, *args, chunk=512,
                                    coarse_lowres=clr, device="cpu")
    assert video.shape == (3, H, W, 3)
    for b in range(3):
        frame = tfr.render_image_device(tm, ref, path[b], *args, chunk=512,
                                        coarse_lowres=clr, device="cpu")
        np.testing.assert_allclose(video[b].numpy(), frame.numpy(),
                                   atol=VIDEO_ATOL, rtol=0)
    assert float(torch.abs(video[0] - video[2]).max()) > 1e-3
    with pytest.raises(ValueError):
        tfr.render_video_device(tm, ref, path[0], *args, device="cpu")


def _rotation(q) -> np.ndarray:
    return jposes.quat_to_rot(np.asarray(q, np.float64))


def test_poses_match_jax():
    rng = np.random.default_rng(5)
    rots = [_rotation(rng.normal(size=4)) for _ in range(4)]
    rots.append(np.diag([1.0, -1.0, -1.0]))          # trace < 0 branch
    for r in rots:
        np.testing.assert_allclose(tposes.rot_to_quat(r),
                                   jposes.rot_to_quat(r), atol=1e-12)
        q = rng.normal(size=4)
        np.testing.assert_allclose(tposes.quat_to_rot(q),
                                   jposes.quat_to_rot(q), atol=1e-12)
    q0 = jposes.rot_to_quat(rots[0])
    for q1 in (jposes.rot_to_quat(rots[1]), -q0, q0 + 1e-5):
        for t in (0.0, 0.3, 1.0):
            np.testing.assert_allclose(tposes.slerp(q0, q1, t),
                                       jposes.slerp(q0, q1, t), atol=1e-12)
    c2w = np.stack([np.concatenate([r, rng.normal(size=(3, 1))], 1)
                    for r in rots[:3]]).astype(np.float32)
    for kind in ("eval", "inter"):
        np.testing.assert_allclose(
            tposes.prepare_render_info(c2w, kind, inter_num=5),
            jposes.prepare_render_info(c2w, kind, inter_num=5), atol=1e-6)
    with pytest.raises(ValueError):
        tposes.prepare_render_info(c2w, "orbit")


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    gt = rng.uniform(size=(H, W, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.1, size=gt.shape), 0, 1) \
        .astype(np.float32)
    want = jax.tree.map(np.asarray, jax.jit(jmetrics.render_metrics)(
        jnp.asarray(pred), jnp.asarray(gt)))
    got = tmetrics.render_metrics(torch.tensor(pred), torch.tensor(gt))
    assert set(got) == {"psnr_nr", "ssim_nr", "wspsnr_nr"} == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-5,
                                   err_msg=k)
    same = tmetrics.render_metrics(torch.tensor(gt), torch.tensor(gt))
    assert float(same["ssim_nr"]) == pytest.approx(1.0, abs=1e-6)
    assert float(same["psnr_nr"]) == pytest.approx(100.0)


def test_render_cli_eval_and_inter(tmp_path):
    """The render CLI on the CPU from the depth stack's depth: an eval frame
    with its metrics, then a 2-pose path in one frame batch."""
    common = ["--height", str(H), "--width", str(W), "--depth-height",
              str(DH), "--depth-width", str(DW), "--depth-stack", "--num",
              "1", "--samples", "16", "--fine-samples", "16", "--device",
              "cpu", "--out", str(tmp_path)]
    summary = trender.main(common)
    files = {p.name for p in tmp_path.iterdir()}
    assert {"0-nr_fine", "0-gt"} <= {f.split(".")[0] for f in files}
    metric = json.loads((tmp_path / "metric.txt").read_text())
    assert {"psnr_nr", "ssim_nr", "wspsnr_nr", "sec_per_frame"} <= set(metric)
    assert all(np.isfinite(v) for v in metric.values())
    assert len(summary["stack_seconds"]) == 1
    # the frame exists: skipped unless --no-skip
    assert trender.main(common)["frames"] == []

    summary = trender.main(common + ["--pose-type", "inter", "--inter-num",
                                     "2", "--frame-batch", "2"])
    stems = {p.name.split(".")[0] for p in tmp_path.iterdir()}
    assert {"0-frame000", "0-frame001"} <= stems
    assert summary["videos"][0]["frames"] == 2
    assert summary["videos"][0]["frame_batch"] == 2


def _read_frame(path) -> np.ndarray:
    """An 8-bit frame the render CLI wrote (a PNG, or a ``.npy`` where
    ``imageio`` is missing)."""
    if path.exists():
        import imageio.v2 as imageio
        return np.asarray(imageio.imread(path))
    return np.load(path.with_suffix(".npy"))


def test_render_cli_on_shards_matches_jax(scene, tmp_path):
    """``render --shards`` on a JAX-written shard of the scene: the CLI's
    eval frame (the exact preset, 32 + 32 samples, the references at the
    shard's depth) and its metrics against the JAX package's
    ``render_image`` on the sample the JAX reader returns, with the same
    weights.  The CLI writes the frame in 8 bits, so each value is held
    to within one level of the JAX frame's and the metrics within 1e-3
    of theirs."""
    with jshards.ShardWriter(tmp_path / "shards") as w:
        w.add(scene[0])
    tm = _port_renderer("exact")
    ckpt = tmp_path / "model.pth"
    torch.save({"network_state_dict": tm.state_dict()}, ckpt)
    summary = trender.main([
        "--ckpt", str(ckpt), "--height", str(H), "--width", str(W),
        "--depth-height", str(DH), "--depth-width", str(DW), "--preset",
        "exact", "--samples", str(DN), "--fine-samples", str(DN),
        "--shards", str(tmp_path / "shards"), "--num", "1", "--device",
        "cpu", "--out", str(tmp_path / "out")])
    assert len(summary["frames"]) == 1
    s = jshards.ShardReader(tmp_path / "shards")[0]
    coords = jinfo.sample_train_coords(np.random.default_rng(0), H, W, 8)
    jdata = jinfo.build_render_sample(s, coords)
    jref = jdata["ref_imgs_info"]
    jref["mvs_depth"] = jnp.asarray(s["depth_panos"][list(jinfo.REF_IDS)])
    jm = JR(height=H, width=W, depth_hw=(DH, DW), depth_sample_num=DN,
            fine_depth_sample_num=DN)
    want = jfr.render_image(jm, tcv.convert_renderer(numpy_sd(tm)), jref,
                            jdata["que_imgs_info"]["c2w"],
                            jdata["que_imgs_info"]["depth_range"],
                            chunk=H * W)["rgb"]
    gt = s["rgb_panos"][jinfo.QUE_ID]
    want8 = np.clip(np.asarray(want) * 255.0, 0, 255).astype(np.int16)
    got8 = _read_frame(tmp_path / "out" / "0-nr_fine.png").astype(np.int16)
    assert got8.shape == (H, W, 3)
    assert np.abs(got8 - want8).max() <= 1
    metrics = jmetrics.render_metrics(want, jnp.asarray(gt))
    for k, v in metrics.items():
        np.testing.assert_allclose(summary["frames"][0][k], float(v),
                                   rtol=1e-3, err_msg=k)


def test_render_cli_refuses_what_is_not_ported(tmp_path):
    """LPIPS weights must be an ``.npz`` or a directory of the released
    files (``tests/test_torch_port_lpips.py`` scores with them); ``--mesh``
    (``tests/test_torch_port_parallel.py``) refuses ranks that do not split
    the rays."""
    for extra, error, match in (
            (["--lpips-weights", "w.bin"], ValueError, "expected an .npz"),
            (["--mesh", "3"], ValueError, "do not split over 3 ranks")):
        with pytest.raises(error, match=match):
            trender.main(["--device", "cpu", "--out", str(tmp_path), *extra])


def test_train_cli_validates_on_stack_depth(tmp_path, monkeypatch, capsys):
    """Two CPU steps with validation after each, the reference depth from
    the frozen stack: the validation metrics are printed and the best
    checkpoint is kept."""
    monkeypatch.chdir(tmp_path)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("\n".join([
        "name: gen_tiny", f"height: {H}", f"width: {W}",
        f"depth_height: {DH}", f"depth_width: {DW}", "depth_sample_num: 8",
        "fine_depth_sample_num: 8", "use_hierarchical_sampling: true",
        "loss: [render]", "val_interval: 1", "save_interval: 1000",
        "seed: 3"]) + "\n")
    logged = []
    trainer = tcli.main(["--cfg", str(cfg), "--steps", "2", "--pool", "1",
                         "--depth-source", "stack", "--device", "cpu"],
                        log_fn=lambda st, m: logged.append((st, m)))
    out = capsys.readouterr().out
    assert "depth source: frozen stack" in out and "psnr_nr=" in out
    vals = [m for _, m in logged if "psnr_nr" in m]
    assert len(vals) == 2
    assert all(np.isfinite(v) for m in vals for v in m.values())
    assert trainer.best_metric == max(m["psnr_nr"] for m in vals)
    assert (tmp_path / "data/model/gen_tiny/best/model.pth").exists()
    # each validation writes gt|pred and depth images of both scenes
    vis = sorted(p.stem for p in (tmp_path / "data/model/gen_tiny/vis")
                 .iterdir())
    assert vis == sorted(f"step{st:06d}-{vi}-{kind}" for st in (1, 2)
                         for vi in (0, 1) for kind in ("gt_pred", "depth"))
