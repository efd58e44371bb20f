"""Port parity of the measurement and evaluation slice: the renderers'
measurement-only ``ablate``, ``utils/roofline.py``'s counts,
``tools/eval_dirs.py`` and ``tools/parity_check.py`` against the JAX
package, and the CPU contracts of ``tools/bench.py`` and
``tools/bench_train.py``.

Renderer shapes are ``test_torch_port_render.py``'s (32x64 render, 32x64
depth, 32 + 32 samples) with its tolerance.  The JAX parameters are drawn
from numpy into a ``jax.eval_shape`` template (an eager or compiled
``init`` of the renderer takes 16-25 s on the CPU).
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import __graft_entry__ as ge
from panogrf_tpu.renderer import full_render as jfr
from panogrf_tpu.renderer.ft_renderer import NeuralRayFtRenderer as JFT
from panogrf_tpu.renderer.presets import preset_kwargs as jpreset
from panogrf_tpu.renderer.renderer import NeuralRayGenRenderer as JR
from panogrf_tpu.train import lpips as JL
from panogrf_tpu.utils import roofline as jrl
from panogrf_tpu_torch.models.mvs import MVSDepthModel
from panogrf_tpu_torch.models.unifuse import UniFuse
from panogrf_tpu_torch.nn.blocks import init_parameters_
from panogrf_tpu_torch.renderer import full_render as tfr
from panogrf_tpu_torch.renderer.ft_renderer import NeuralRayFtRenderer as TFT
from panogrf_tpu_torch.renderer.presets import preset_kwargs
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer as TR
from panogrf_tpu_torch.tools import bench, bench_train, eval_dirs
from panogrf_tpu_torch.tools import parity_check
from panogrf_tpu_torch.train.depth_trainer import (DepthTrainConfig,
                                                   DepthTrainer)
from panogrf_tpu_torch.train.trainer import Trainer, TrainerConfig
from panogrf_tpu_torch.utils import roofline as trl
from panogrf_tpu_torch.utils.from_jax import load_jax_params
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
H, W, DH, DW, DN, CHUNK = 32, 64, 32, 64, 32, 64
RGB_ATOL = 1e-3          # test_torch_port_render.py's
COMMON = dict(height=H, width=W, depth_sample_num=DN,
              fine_depth_sample_num=DN)
FT = dict(rfn=2, ray_feats_hw=(DH // 4, DW // 4), **COMMON)


def random_params(init, *args, seed=0):
    """Seeded values in the shapes of ``init(key, *args)``: LeCun-normal
    kernels, norm scales near 1, small biases."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0), *args)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if len(s.shape) >= 2:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (0.05 * rng.normal(size=s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def scene():
    """Random parameters, the scene's reference data prepared once by each
    package (``prepare_ref`` reads no ``ablate``) and the port's frame
    without an ablation."""
    data = ge._tiny_data(H, W, DH, DW, rn=8)
    params = random_params(JR(**COMMON, depth_hw=(DH, DW)).init, data)
    ref_info = {k: np.array(v) for k, v in data["ref_imgs_info"].items()}
    que = {k: np.array(data["que_imgs_info"][k])
           for k in ("c2w", "depth_range")}
    args = (que["c2w"], que["depth_range"], ref_info["depth_range"])
    jref = jfr.prepare_ref_data(
        JR(**COMMON, depth_hw=(DH, DW),
           **jpreset("serving", compute_dtype="float32")), params, ref_info)
    pm = load_jax_params(TR(**COMMON, depth_hw=(DH, DW), device="cpu",
                            **preset_kwargs("serving",
                                            compute_dtype="float32")),
                         params)
    tref = tfr.prepare_ref_data(pm, ref_info, device="cpu")
    plain = tfr.render_image_device(pm, tref, *args, chunk=CHUNK,
                                    coarse_lowres=2, device="cpu")
    return params, args, jref, tref, plain


@pytest.mark.parametrize("ablate", ["agg", "gather", "agg+gather", "attn"])
def test_gen_renderer_ablate_match_jax(scene, ablate):
    """The serving frame (depth-major rows, merged map, decode-on-map, the
    coarse pass at (H/2, W/2)) with each stage ablated."""
    params, args, jref, tref, plain = scene
    jm = JR(**COMMON, depth_hw=(DH, DW), ablate=ablate,
            **jpreset("serving", compute_dtype="float32"))
    want = np.asarray(jfr.render_image_device(jm, params, jref, *args,
                                              chunk=CHUNK, coarse_lowres=2))
    tm = TR(**COMMON, depth_hw=(DH, DW), ablate=ablate,
            **preset_kwargs("serving", compute_dtype="float32"),
            device="cpu")
    load_jax_params(tm, params)
    got = tfr.render_image_device(tm, tref, *args, chunk=CHUNK,
                                  coarse_lowres=2, device="cpu")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=RGB_ATOL, rtol=0)
    # the stand-ins change the frame, the attention's parameters stay
    assert (got - plain).abs().max() > 1e-3
    assert "agg_net.agg_impl.ray_attention.w_qs.weight" in tm.state_dict()


def test_ablate_refuses_unknown_stage():
    with pytest.raises(ValueError, match="unknown ablate"):
        TR(**COMMON, depth_hw=(DH, DW), ablate="pool", device="cpu")
    with pytest.raises(ValueError, match="unknown ablate"):
        TFT(**FT, ablate="pool", device="cpu")


@pytest.fixture(scope="module")
def ft_scene():
    data = ge._tiny_data(H, W, DH, DW, rn=8)
    return data, random_params(JFT(**FT).init, data, seed=1)


@pytest.mark.parametrize("ablate", ["agg", "gather", "agg+gather", "attn"])
def test_ft_renderer_ablate_match_jax(ft_scene, ablate):
    """The ft renderer's deterministic forward (per-map gathers, ray-major
    rows): "agg" replaces its aggregation, "gather" (no merged map) and
    "attn" (its aggregation nets keep the attention) leave it as the JAX
    module does.  Colours and depths within RGB_ATOL (depths also its
    relative share): the fine samples amplify rounding as in the frames."""
    data, params = ft_scene
    want = jax.jit(JFT(**FT, ablate=ablate).apply)(params, data)
    tm = load_jax_params(TFT(**FT, ablate=ablate, device="cpu"),
                         params)
    with torch.no_grad():
        got = tm(jax.tree.map(lambda a: torch.tensor(np.array(a)), data))
    for k, rtol in (("pixel_colors_nr", 0), ("pixel_colors_nr_fine", 0),
                    ("render_depth", RGB_ATOL),
                    ("render_depth_fine", RGB_ATOL)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=RGB_ATOL, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("point", [
    dict(h=512, w=1024),
    dict(h=512, w=1024, lowres_coarse=2),
    dict(h=512, w=1024, lowres_coarse=4, stride=2, stride_fine=8),
    dict(h=256, w=512, dn_coarse=32, dn_fine=48, v=3,
         coarse_geometry_only=False, dtype="float32"),
    dict(h=64, w=128, stride=1, stride_fine=1)])
def test_roofline_counts_match_jax(point):
    """The same operations, bytes and rows as the JAX module; the prices
    are the card's (H100 SXM5 at 700 W), and no TPU row latency enters:
    the latency floor and its fraction are None."""
    a, b = trl.frame_model(**point), jrl.frame_model(**point)
    for k in ("agg_flops", "agg_hbm_bytes", "gather_rows",
              "gather_hbm_bytes", "dtype"):
        assert a[k] == b[k], k
    assert trl.GATHER_NS_PER_ROW is None
    assert a["gather_latency_floor_s"] is None
    n = point["h"] * point["w"]
    assert trl.pool_flops(n, 3, geometry_only=True) == \
        jrl.pool_flops(n, 3, geometry_only=True)
    assert trl.attention_flops(n, 48) == jrl.attention_flops(n, 48)
    assert trl.agg_stage(n, 64, dtype_bytes=4) == \
        trl.StageCost(*vars(jrl.agg_stage(n, 64, dtype_bytes=4)).values())
    for k in ("rows", "hbm_bytes"):
        assert trl.gather_stage(n, 64, 4)[k] == jrl.gather_stage(n, 64, 4)[k]
    assert trl.gather_stage(n, 64, 4)["latency_floor_s"] is None
    ach = trl.achieved(a, 0.25, 0.5)
    peak = {"bfloat16": 989e12, "float32": 67e12}[a["dtype"]]
    assert ach["agg_mfu"] == pytest.approx(a["agg_flops"] / (0.25 * peak))
    assert ach["gather_hbm_frac"] == pytest.approx(
        a["gather_hbm_bytes"] / (0.5 * 3.35e12))
    assert ach["gather_latency_model_frac"] is None


def _run_jax_tool(monkeypatch, name, argv):
    """``tools/<name>.py`` of the JAX package, its ``main`` on ``argv``."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return mod.main()


def test_eval_dirs_matches_jax_tool(tmp_path, monkeypatch):
    """Both tools on the same files (the render CLI's layout: ``{k}-gt``
    beside the renders, one ground truth without a render), LPIPS from a
    seeded ``.npz`` in the JAX layout; then the port on the reference's
    layout (``{k}.png`` in a directory of its own) without LPIPS."""
    from PIL import Image
    rng = np.random.default_rng(4)
    same, gt_dir = tmp_path / "same", tmp_path / "gt"
    for d in (same, gt_dir):
        d.mkdir()
    for k in range(3):
        gt = rng.integers(0, 256, size=(32, 64, 3), dtype=np.uint8)
        noise = rng.integers(-20, 21, size=gt.shape)
        pr = np.clip(gt.astype(int) + noise, 0, 255).astype(np.uint8)
        Image.fromarray(gt).save(same / f"{k}-gt.png")
        Image.fromarray(gt).save(gt_dir / f"{k}.png")
        if k < 2:          # scene 2 has no render
            Image.fromarray(pr).save(same / f"{k}-nr_fine.png")
    weights, cin = {}, 3
    for i, cout in enumerate(c for c in JL._VGG16 if c != "M"):
        weights[f"vgg/conv{i}/kernel"] = rng.normal(
            size=(3, 3, cin, cout)).astype(np.float32) / np.sqrt(9 * cin)
        weights[f"vgg/conv{i}/bias"] = np.zeros(cout, np.float32)
        cin = cout
    for i, c in enumerate((64, 128, 256, 512, 512)):
        weights[f"lin{i}"] = rng.uniform(0.2, 2, size=c).astype(np.float32)
    np.savez(tmp_path / "lpips.npz", **weights)
    argv = ["--dir_gt", str(same), "--dir_pr", str(same), "--lpips-weights",
            str(tmp_path / "lpips.npz")]
    _run_jax_tool(monkeypatch, "eval_dirs", argv)
    want = json.loads((same / "metric.txt").read_text())
    got = eval_dirs.main(argv + ["--device", "cpu"])
    assert got == json.loads((same / "metric.txt").read_text())
    assert got.keys() == want.keys() and got["lpips"] > 0
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-5), k
    apart = eval_dirs.main(["--dir_gt", str(gt_dir), "--dir_pr", str(same),
                            "--device", "cpu"])
    assert apart == {**got, "lpips": None}
    assert eval_dirs.main(["--dir_gt", str(tmp_path / "empty"), "--dir_pr",
                           str(same), "--device", "cpu"]) is None


@pytest.fixture(scope="module")
def trainer_files(tmp_path_factory):
    """The three files as the port's trainers write them (``Trainer.save``
    and ``DepthTrainer.save``), from seeded modules at the CPU shapes."""
    root = tmp_path_factory.mktemp("ckpts")
    g = torch.Generator().manual_seed(0)
    renderer = TR(height=H, width=W, depth_hw=(DH, DW), device="cpu",
                  generator=g)
    Trainer(renderer, None, TrainerConfig(name="gen", save_dir=str(root))) \
        .save("latest")
    mono = UniFuse()
    init_parameters_(mono, g)
    DepthTrainer(mono, None, DepthTrainConfig(name="mono",
                                              save_dir=str(root))).save()
    mvs = MVSDepthModel(num_hypotheses=8)
    init_parameters_(mvs, g)
    with torch.no_grad():
        mvs.decoders2[2].conv2.bias.fill_(3.0)      # depth off 0
    DepthTrainer(mvs, None, DepthTrainConfig(name="mvs", save_dir=str(root)),
                 frozen={"d_net": mono}).save()
    return {"renderer": root / "gen" / "latest" / "model.pth",
            "mono": root / "mono" / "checkpoint_0.pth",
            "mvs": root / "mvs" / "checkpoint_0.pth"}


def test_parity_check_passes_trainer_files_and_fails_misshaped(
        trainer_files, tmp_path, capsys, monkeypatch):
    # a 16x32 frame (the smallest ResUNetLight takes) keeps the exact
    # render quick; depth at the renderer's 32x64
    small = ["--height", "16", "--width", "32", "--depth-height", str(DH),
             "--depth-width", str(DW), "--device", "cpu"]
    argv = ["--renderer-pth", str(trainer_files["renderer"]), "--mono-pth",
            str(trainer_files["mono"]), "--mvs-pth", str(trainer_files["mvs"]),
            "--num", "1", "--out", str(tmp_path / "out"), *small]
    assert parity_check.main(argv) == 0
    out = capsys.readouterr().out
    for name in ("mono (UniFuse)", "mvs (360-MVSNet)", "mvs d_net (UniFuse)",
                 "renderer (NeuralRayGen)"):
        assert f"[load] {name}: OK" in out
    mean = json.loads((tmp_path / "out" / "metric.txt").read_text())
    assert np.isfinite(mean["psnr_nr"]) and "lpips" not in mean
    # the gate on that render's metric.txt (the render step left out, the
    # renderer's file alone): a PSNR far above the expected passes, far
    # below fails
    monkeypatch.setattr(parity_check.render, "main", lambda argv: None)
    gate = ["--renderer-pth", str(trainer_files["renderer"]), "--out",
            str(tmp_path / "out"), *small, "--expected-psnr"]
    assert parity_check.main(gate + ["-50"]) == 0
    assert "-> PASS" in capsys.readouterr().out
    assert parity_check.main(gate + ["500"]) == 1
    assert "-> FAIL" in capsys.readouterr().out

    raw = torch.load(trainer_files["renderer"], weights_only=False)
    sd = raw["network_state_dict"]
    key = "agg_net.agg_impl.out_geometry_fc.0.weight"
    sd[key] = sd[key][:, :8]
    sd["extra.weight"] = torch.zeros(1)
    del sd["vis_encoder.out_conv.0.1.weight"]
    bad = tmp_path / "bad.pth"
    torch.save(raw, bad)
    assert parity_check.main(["--renderer-pth", str(bad),
                              "--key-check-only", *small]) == 1
    out = capsys.readouterr().out
    assert "renderer (NeuralRayGen): 3 PROBLEMS" in out
    for line in (f"shape {key}: (16, 8) vs (16, 16)", "unexpected extra",
                 "missing vis_encoder.out_conv.0.1.weight"):
        assert line in out


def test_bench_main_json_contract(monkeypatch, capsys):
    """``tools.bench --device cpu --no-roofline``: one JSON line with the
    serving number, the turbo point and no kernel launch on the CPU; it
    refuses a video batch with DINER.  The CPU frame is cut from 64x128 to
    16x32 (the smallest the image encoder takes) for time."""
    monkeypatch.setitem(bench.SIZES, "cpu", (16, 32, 16, 32))
    rec = bench.main(["--device", "cpu", "--no-roofline"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert rec["metric"] == "torch_novel_pano_render_16x32_cpu"
    assert rec["unit"] == "ms/frame" and rec["value"] > 0
    assert rec["turbo_ms_per_frame"] > 0 and rec["vs_baseline"] is None
    assert len(rec["runs"]) == 3 and rec["device"] == "cpu"
    assert rec["mlp2_launches"] == 0 and "agg_mfu" not in rec
    for extra in (["--diner"], ["--light-coarse"]):
        with pytest.raises(SystemExit):
            bench.parse_args(["--video-batch", "2", *extra])


def test_bench_train_prints_a_line_per_recipe(capsys):
    rows = bench_train.main(["--device", "cpu", "--recipe", "all",
                             "--iters", "1", "--rays", "64"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines == rows
    assert [r["metric"] for r in rows] == ["torch_train_gen_64x128_cpu",
                                           "torch_train_mvs_32x64_b2_cpu"]
    for r in rows:
        assert r["unit"] == "ms/step" and r["value"] > 0
        assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
        assert r["mlp2_launches_per_step"] == [0, 0]
