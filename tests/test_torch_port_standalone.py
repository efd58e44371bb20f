"""The port stands alone: no module of ``panogrf_tpu_torch`` imports JAX,
flax, the JAX package, orbax, tensorstore or zstandard, and its entry
points run on CUDA unless the caller asks for the CPU.  It is whole:
every module of the JAX package and every JAX tool has its port, but for
the files ``UNPORTED`` names."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import panogrf_tpu_torch
from panogrf_tpu_torch.models import depth_stack
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer.ft_renderer import NeuralRayFtRenderer
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.tools import (bench, bench_train, eval_dirs,
                                     parity_check, profile_honest,
                                     profile_mvs, profile_render, render,
                                     render_ft, render_mv, train_ft,
                                     train_renderer)
from panogrf_tpu_torch.train import lpips
from panogrf_tpu_torch.train.trainer import Trainer
from torch_port_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "panogrf_tpu_torch"
# JAX package files (relative to ``panogrf_tpu/``) without a port file of
# the same path, each with where its work went or why it has none
UNPORTED = {
    "ops/pallas/__init__.py": "ops/kernels/ (the Pallas kernels' wrappers)",
    "ops/pallas/fused_mlp.py": "ops/kernels/fused_mlp.py + csrc/fused_mlp.cu",
    "utils/torch_convert.py": "the port keeps the reference state-dict "
                              "layout; utils/from_jax.py is the inverse",
    "utils/observability.py": "no caller in either package: the trainers "
                              "log through log_fn",
}


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        panogrf_tpu_torch.__path__, "panogrf_tpu_torch."))


def test_every_module_imports_without_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'panogrf_tpu', 'orbax', "
            "'tensorstore', 'zstandard'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_mentions_jax():
    pattern = re.compile(r"import jax|from jax|flax|panogrf_tpu\.|"
                         r"(import|from) (orbax|tensorstore|zstandard)")
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert len(_modules()) >= 85
    # the depth stack's, the video slice's, depth training's, the
    # multi-view and finetuning slice's, the renderer modes', the
    # depth-net variants', the data pipeline's, the multi-GPU, the
    # measurement and evaluation modules, the stage profilers and the
    # orbax checkpoint reader are among them
    assert {f"panogrf_tpu_torch.{m}" for m in (
        "core.cubemap", "nn.resnet", "nn.fusion", "models.unifuse",
        "models.mvs", "models.depth_stack", "ops.cost_volume",
        "renderer.poses", "train.metrics", "tools.render",
        "train.depth_trainer", "train.losses", "utils.visualize",
        "tools.train_mono", "tools.train_depth", "tools.eval_depth",
        "renderer.sample_utils", "renderer.ft_renderer", "train.ft_losses",
        "tools.train_ft", "tools.render_ft", "tools.render_mv",
        "renderer.diner", "renderer.sph_solver", "data.database",
        "tools.render_cubes", "tools.ab_quality", "core.tangent",
        "nn.erp_tp", "models.fnet", "models.uncert", "data.shards",
        "data.lmdb_reader", "data.lmdb_import", "data.readers",
        "data.augment", "data.online", "tools.prepare_data",
        "tools.import_lmdb", "parallel.mesh", "parallel.launch",
        "parallel.sharded_train", "parallel.sharded_render",
        "parallel.programs", "tools.bench", "tools.bench_train",
        "tools.eval_dirs", "tools.parity_check", "train.lpips",
        "utils.roofline", "tools._stage_timer", "tools.profile_honest",
        "tools.profile_render", "tools.profile_mvs", "utils.zstd",
        "utils.ocdbt", "utils.orbax_read")} <= set(_modules())
    assert not offenders, offenders


def test_every_jax_module_and_tool_has_its_port():
    """Each ``.py`` file of ``panogrf_tpu/`` has the port file of the same
    path under ``panogrf_tpu_torch/`` (but for ``UNPORTED``), and each JAX
    tool under ``tools/``, and the root ``bench.py``, has its port under
    ``panogrf_tpu_torch/tools/``."""
    jax_pkg = ROOT / "panogrf_tpu"
    missing = sorted(
        rel for p in jax_pkg.rglob("*.py")
        if "__pycache__" not in p.parts
        and (rel := p.relative_to(jax_pkg).as_posix()) not in UNPORTED
        and not (PKG / rel).is_file())
    assert not missing, missing
    assert all((jax_pkg / rel).is_file() and not (PKG / rel).exists()
               for rel in UNPORTED)
    tools = sorted(p.name for p in (ROOT / "tools").glob("*.py")) \
        + ["bench.py"]
    assert {"profile_honest.py", "profile_mvs.py", "profile_render.py",
            "bench.py"} <= set(tools)
    assert not [t for t in tools if not (PKG / "tools" / t).is_file()]


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device="cpu"`` and with no CUDA device, each entry point
    raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(height=32, width=64, depth_hw=(32, 64), depth_sample_num=8,
              fine_depth_sample_num=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        NeuralRayGenRenderer(**kw)
    model = NeuralRayGenRenderer(**kw, device="cpu")
    rng = np.random.default_rng(0)
    ref_info = {"imgs": rng.uniform(size=(2, 32, 64, 3)),
                "mvs_depth": rng.uniform(1, 5, size=(2, 32, 64, 1)),
                "w2c": np.tile(np.eye(3, 4), (2, 1, 1))}
    with pytest.raises(RuntimeError, match="CUDA"):
        full_render.prepare_ref_data(model, ref_info)
    ref = full_render.prepare_ref_data(model, ref_info, device="cpu")
    c2w, dr = np.eye(3, 4), np.asarray([[0.5, 15.0]])
    with pytest.raises(RuntimeError, match="CUDA"):
        full_render.render_image_device(model, ref, c2w, dr, dr.repeat(2, 0),
                                        chunk=256)
    rgb = full_render.render_image_device(model, ref, c2w, dr,
                                          dr.repeat(2, 0), chunk=256,
                                          device="cpu")
    assert rgb.shape == (32, 64, 3)
    c2ws = np.stack([c2w, c2w])
    with pytest.raises(RuntimeError, match="CUDA"):
        full_render.render_video_device(model, ref, c2ws, dr,
                                        dr.repeat(2, 0), chunk=256)
    assert full_render.render_video_device(
        model, ref, c2ws, dr, dr.repeat(2, 0), chunk=256,
        device="cpu").shape == (2, 32, 64, 3)
    ref_info["depth_range"] = dr.repeat(2, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        full_render.render_image(model, ref_info, c2w, dr, chunk=512)

    # the depth stack and the render CLI: CUDA unless asked
    kw_stack = dict(mono_hw=(64, 128), depth_hw=(32, 64),
                    mvs_kwargs={"num_hypotheses": 8, "cnn3d_base": 8})
    with pytest.raises(RuntimeError, match="CUDA"):
        depth_stack.init_depth_stack(0, **kw_stack)
    with pytest.raises(RuntimeError, match="CUDA"):
        depth_stack.load_depth_stack(None, None, **kw_stack)
    stack = depth_stack.init_depth_stack(0, **kw_stack, device="cpu")
    assert next(stack.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        render.main(["--height", "32", "--width", "64", "--num", "0"])

    # the training CLI and the trainer's model: CUDA unless asked
    argv = ["--cfg", str(ROOT / "configs/gen_synthetic_small.yaml"),
            "--steps", "1", "--pool", "1"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_renderer.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_renderer.build(train_renderer.parse_args(argv))
    trainer = train_renderer.build(
        train_renderer.parse_args(argv + ["--device", "cpu"]))[0]
    assert isinstance(trainer, Trainer)
    assert trainer.model.directions.device.type == "cpu"

    # the finetuning renderer and CLIs, and render_mv: CUDA unless asked
    with pytest.raises(RuntimeError, match="CUDA"):
        NeuralRayFtRenderer(rfn=2, ray_feats_hw=(2, 4), height=8, width=16)
    assert NeuralRayFtRenderer(rfn=2, ray_feats_hw=(2, 4), height=8,
                               width=16, device="cpu").directions \
        .device.type == "cpu"
    small = ["--height", "32", "--width", "64", "--depth-height", "32",
             "--depth-width", "64"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ft.main(small + ["--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        render_ft.main(["--ckpt", "model.pth", "--height", "32", "--width",
                        "64"])
    with pytest.raises(RuntimeError, match="CUDA"):
        render_mv.main(small + ["--num", "1"])
    ft = train_ft.FtTrainer(train_ft.parse_args(
        small + ["--rays", "8", "--device", "cpu"]))
    assert ft.model.directions.device.type == "cpu"

    # the measurement and evaluation tools, the stage profilers and LPIPS:
    # CUDA unless asked
    for tool, argv in ((bench, []), (bench_train, []),
                       (eval_dirs, ["--dir_gt", ".", "--dir_pr", "."]),
                       (parity_check, ["--renderer-pth", "model.pth"]),
                       (profile_honest, []), (profile_render, []),
                       (profile_mvs, [])):
        with pytest.raises(RuntimeError, match="CUDA"):
            tool.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        lpips.load_lpips_weights("w.npz")
