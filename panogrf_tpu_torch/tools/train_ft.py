"""Finetune the renderer on one scene.

    python -m panogrf_tpu_torch.tools.train_ft [--cfg <yaml>] \\
        [--gen-ckpt model.pth] [--steps N] [--height H --width W] \\
        [--depth-height DH --depth-width DW] [--scene-seed S] [--rays R] \\
        [--lr LR] [--lr-ray-feats LR] [--depth-guided] \\
        [--ft-fixed-sigma S] [--name NAME] [--device cpu]

Port of the repo's ``tools/train_ft.py``.  The scene is one procedural
3-view sample (seed ``--scene-seed``).  The ft renderer starts from a
generalizable renderer (``--gen-ckpt``, a ``model.pth`` the training CLI
writes or an orbax directory of the JAX trainer, else random weights):
its ray features are the gen init net's output on the reference views
[0, 2] at the scene's true depth, the
other weights copy over by name.  Each step draws the query view among
the two references and ``--rays`` random rays, and takes one Adam step
on the render loss, with two parameter groups at constant learning
rates and no clipping: the ray features at ``--lr-ray-feats``, every
other weight at ``--lr``.  ``--depth-guided`` draws the fine samples
within 3 sigma of the cached depth (sigma ``--ft-fixed-sigma``, else 10%
of the depth).  A last forward on the held-out query view 1 prints the
rays' MSE and PSNR, and the weights are saved as
``data/model/<name>/ft_latest/model.pth`` (``network_state_dict`` in the
reference ft layout, which ``tools.render_ft`` reads).

With ``--cfg`` (a ``configs/ft/*.yaml`` recipe) the yaml gives the sizes,
the scene spacing, ``--lr``, ``--steps`` and ``--name``; flags given on
the command line win.  The query view is drawn with a torch generator
(the JAX tool draws it with ``jax.random``); the rays come from numpy's
``default_rng(2022)`` in the JAX tool's order.  It runs on the CUDA
device and raises without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from panogrf_tpu_torch.config import load_config
from panogrf_tpu_torch.data import imgs_info
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_three_view_sample)
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.renderer.ft_renderer import (NeuralRayFtRenderer,
                                                    ft_depth_range_at_coords,
                                                    init_ft_params_from_gen)
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.train.losses import render_loss, total_loss
from panogrf_tpu_torch.train.trainer import (ADAM_BETAS, ADAM_EPS,
                                             load_checkpoint_params)
from panogrf_tpu_torch.utils.device import resolve_device

SEED = 2022


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", default=None,
                    help="ft recipe yaml; flags given on the command line "
                         "win")
    ap.add_argument("--gen-ckpt", default=None,
                    help="generalizable renderer model.pth, or an orbax "
                         "directory of the JAX trainer")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--depth-height", type=int, default=128)
    ap.add_argument("--depth-width", type=int, default=256)
    ap.add_argument("--m3d-dist", type=float, default=0.5)
    ap.add_argument("--scene-seed", type=int, default=123)
    ap.add_argument("--rays", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--lr-ray-feats", type=float, default=1e-2)
    ap.add_argument("--depth-guided", action="store_true",
                    help="fine samples within 3 sigma of the cached depth")
    ap.add_argument("--ft-fixed-sigma", type=float, default=None)
    ap.add_argument("--name", default="ft_run")
    ap.add_argument("--log-interval", type=int, default=20,
                    help="print the loss every N steps (and after step 1)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.cfg:
        cfg = load_config(args.cfg)
        given = {a.split("=")[0].lstrip("-").replace("-", "_")
                 for a in (sys.argv[1:] if argv is None else argv)
                 if a.startswith("--")}
        for flag, val in [("height", cfg.data.height),
                          ("width", cfg.data.width),
                          ("depth_height", cfg.mvs.depth_height),
                          ("depth_width", cfg.mvs.depth_width),
                          ("m3d_dist", cfg.data.m3d_dist),
                          ("lr", cfg.train.lr_init),
                          ("steps", cfg.train.total_step),
                          ("name", cfg.train.name)]:
            if flag not in given:
                setattr(args, flag, val)
    return args


def make_optimizer(model: NeuralRayFtRenderer, lr: float,
                   lr_ray_feats: float) -> torch.optim.Adam:
    """Adam (optax's defaults) over two groups, as the JAX tool's
    ``optax.multi_transform``: the ray features at ``lr_ray_feats``, the
    other parameters at ``lr``."""
    ray_feats = list(model.ray_feats.parameters())
    ids = {id(p) for p in ray_feats}
    net = [p for p in model.parameters() if id(p) not in ids]
    return torch.optim.Adam([{"params": ray_feats, "lr": lr_ray_feats},
                             {"params": net, "lr": lr}], betas=ADAM_BETAS,
                            eps=ADAM_EPS)


def ft_step(model: NeuralRayFtRenderer, opt: torch.optim.Optimizer,
            batch: dict, generator: torch.Generator) -> torch.Tensor:
    """One step: forward, the render loss, backward and the Adam update;
    each parameter's ``.grad`` keeps the step's gradient.  Returns the
    loss."""
    opt.zero_grad(set_to_none=True)
    loss = total_loss(render_loss(model(batch, generator), batch))
    loss.backward()
    opt.step()
    return loss.detach()


class FtTrainer:
    """One scene's finetuning as the CLI runs it: ``fit``, ``validate``,
    ``save``."""

    def __init__(self, args: argparse.Namespace, log_fn=None):
        self.args = args
        self.log_fn = log_fn or (lambda step, m: None)
        dev = resolve_device(args.device)
        h, w = self.hw = (args.height, args.width)
        dh, dw = args.depth_height, args.depth_width
        s = make_three_view_sample(
            SphereScene.random(args.scene_seed, device=dev), h, w,
            args.m3d_dist, seed=args.scene_seed)
        self.rng = np.random.default_rng(SEED)
        coords = imgs_info.sample_train_coords(self.rng, h, w, args.rays,
                                               device=dev)
        self.data = imgs_info.build_render_sample(s, coords,
                                                  src_for_mvs=False)
        ref_info = self.data["ref_imgs_info"]
        ref_info["mvs_depth"] = resize_linear(
            s["depth_panos"][list(imgs_info.REF_IDS)], (dh, dw), axes=(1, 2))
        gen = NeuralRayGenRenderer(
            height=h, width=w, depth_hw=(dh, dw), device=dev,
            generator=torch.Generator().manual_seed(0))
        if args.gen_ckpt:
            gen.load_state_dict(load_checkpoint_params(args.gen_ckpt))
            print(f"restored gen checkpoint {args.gen_ckpt}")
        self.model = NeuralRayFtRenderer(
            rfn=len(imgs_info.REF_IDS), ray_feats_hw=(dh // 4, dw // 4),
            height=h, width=w, device=dev)
        self.cache = init_ft_params_from_gen(self.model, gen, ref_info)
        self.opt = make_optimizer(self.model, args.lr, args.lr_ray_feats)
        self.sample = s
        self.c2w_all = imgs_info.c2w_from_w2c(
            imgs_info.pose_w2c(s["rots"], s["trans"]))
        self.generator = torch.Generator().manual_seed(SEED)
        self.pick = torch.Generator().manual_seed(SEED)
        self.step = 0

    def batch(self) -> dict:
        """The next step's batch: a reference view as the query, random
        rays and, with depth guidance, the cached depth's range there."""
        args, (h, w) = self.args, self.hw
        i = int(torch.randint(len(imgs_info.REF_IDS), (1,),
                              generator=self.pick))
        qid = imgs_info.REF_IDS[i]
        coords = imgs_info.sample_train_coords(
            self.rng, h, w, args.rays, device=self.c2w_all.device)
        que = {"c2w": self.c2w_all[qid],
               "imgs": self.sample["rgb_panos"][qid][None],
               "coords": coords,
               "depth_range": self.data["que_imgs_info"]["depth_range"]}
        if args.depth_guided:
            # i indexes the reference views, the cache's rows
            que["ft_depth_range"] = ft_depth_range_at_coords(
                self.cache, i, coords, h, w, args.ft_fixed_sigma)
        return {"ref_imgs_info": self.data["ref_imgs_info"],
                "que_imgs_info": que}

    def fit(self, num_steps: int) -> None:
        self.model.train()
        t0 = time.time()
        for k in range(num_steps):
            loss = ft_step(self.model, self.opt, self.batch(),
                           self.generator)
            self.step += 1
            if self.step % self.args.log_interval == 0 or k == 0:
                m = {"loss": float(loss)}
                print(f"step {self.step} ({time.time() - t0:.0f}s): "
                      f"loss={m['loss']:.4f}", flush=True)
                self.log_fn(self.step, m)

    @torch.no_grad()
    def validate(self) -> dict:
        """MSE and PSNR of the fine pass's colours at the first rays of
        the held-out query view."""
        out = self.model(self.data)
        mse = float(torch.mean((out["pixel_colors_gt"]
                                - out["pixel_colors_nr_fine"]) ** 2))
        return {"mse": mse, "psnr": 10 * math.log10(1.0 / max(mse, 1e-9))}

    def ckpt_path(self) -> Path:
        return Path("data/model") / self.args.name / "ft_latest" / \
            "model.pth"

    def save(self) -> Path:
        path = self.ckpt_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"step": self.step,
                    "network_state_dict": self.model.state_dict(),
                    "optimizer_state_dict": self.opt.state_dict()}, path)
        return path


def main(argv=None, log_fn=None) -> FtTrainer:
    """Run the CLI on ``argv``; returns the finetuned ``FtTrainer``."""
    args = parse_args(argv)
    trainer = FtTrainer(args, log_fn)
    trainer.fit(args.steps)
    val = trainer.validate()
    print(f"val ray MSE vs held-out query view: {val['mse']:.5f} "
          f"(psnr {val['psnr']:.2f})")
    print(f"saved {trainer.save()}")
    return trainer


if __name__ == "__main__":
    main()
