"""Render a per-scene finetuned (ft) checkpoint to full panoramas.

    python -m panogrf_tpu_torch.tools.render_ft --ckpt model.pth \\
        [--height H --width W] [--scene-seed S] [--pose-type eval|inter] \\
        [--inter-num K] [--chunk C] [--out DIR] [--device cpu]

Port of the repo's ``tools/render_ft.py``.  It reads the ``model.pth``
that ``tools.train_ft`` writes, takes the number of views and the ray
features' size from its ``ray_feats.{i}`` (1, F, fh, fw), rebuilds the
scene from ``--scene-seed`` (the train_ft run's), encodes the references
once and renders through ``full_render.render_image``, ``--chunk`` rays
per pass.  'eval' renders the held-out query view and writes
``que-nr_fine.png``, ``que-gt.png`` and ``metric.txt`` (PSNR / SSIM /
WS-PSNR and the seconds per frame); 'inter' renders ``--inter-num`` poses
between the two references as ``frame<k>.png``.  Without imageio the
images are saved as ``.npy``.  It runs on the CUDA device and raises
without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from panogrf_tpu_torch.data import imgs_info
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_three_view_sample)
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer import poses as P
from panogrf_tpu_torch.renderer.ft_renderer import NeuralRayFtRenderer
from panogrf_tpu_torch.tools.render import save_image
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.train.trainer import load_checkpoint_params
from panogrf_tpu_torch.utils.device import resolve_device, synchronize


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True,
                    help="model.pth written by tools.train_ft")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--m3d-dist", type=float, default=0.5)
    ap.add_argument("--scene-seed", type=int, default=123,
                    help="must match the train_ft run")
    ap.add_argument("--pose-type", default="eval", choices=["eval", "inter"])
    ap.add_argument("--inter-num", type=int, default=12)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--out", default="data/render_ft_out")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def load_ft(path, height: int, width: int,
            device: str | torch.device = "cuda") -> NeuralRayFtRenderer:
    """The ft renderer of a checkpoint, sized by its ``ray_feats.{i}``."""
    sd = load_checkpoint_params(path)
    rfn = sum(k.startswith("ray_feats.") for k in sd)
    _, feat_dim, fh, fw = sd["ray_feats.0"].shape
    model = NeuralRayFtRenderer(rfn=rfn, ray_feats_hw=(fh, fw),
                                feat_dim=feat_dim, height=height,
                                width=width, device=device)
    model.load_state_dict(sd)
    return model.eval()


@torch.inference_mode()
def encode_refs(model: NeuralRayFtRenderer, ref_info: dict) -> dict:
    """The references' maps, as ``full_render.render_image`` takes them."""
    ref_data = model.prepare_ref(ref_info["imgs"])
    ref_data["w2c"] = ref_info["w2c"]
    return ref_data


def main(argv=None) -> dict:
    """Run the tool on ``argv``; returns 'eval''s metrics or the path's
    frame count and timing."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    model = load_ft(args.ckpt, h, w, device=dev)
    print(f"ckpt ray_feats: {tuple(model.ray_feats_maps().shape)}")
    s = make_three_view_sample(
        SphereScene.random(args.scene_seed, device=dev), h, w,
        args.m3d_dist, seed=args.scene_seed)
    data = imgs_info.build_render_sample(
        s, imgs_info.sample_train_coords(np.random.default_rng(0), h, w, 8,
                                         device=dev), src_for_mvs=False)
    ref_info = data["ref_imgs_info"]
    qdr = data["que_imgs_info"]["depth_range"]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.pose_type == "inter":
        c2w_all = imgs_info.c2w_from_w2c(
            imgs_info.pose_w2c(s["rots"], s["trans"])).cpu().numpy()
        path = P.prepare_render_info(c2w_all, "inter",
                                     inter_num=args.inter_num)
        frames = []
        synchronize(dev)
        t0 = time.perf_counter()
        ref_data = encode_refs(model, ref_info)
        for c2w in path:
            frames.append(full_render.render_image(
                model, ref_info, c2w, qdr, args.chunk, ref_data=ref_data,
                device=dev)["rgb"].cpu().numpy())
        synchronize(dev)
        seconds = time.perf_counter() - t0
        for fi, rgb in enumerate(frames):
            save_image(out_dir / f"frame{fi:03d}.png", rgb)
        print(f"wrote {len(frames)} path frames to {out_dir} "
              f"({seconds / len(frames):.3f} s/frame)")
        return {"frames": len(frames), "seconds": seconds,
                "sec_per_frame": seconds / len(frames)}

    synchronize(dev)
    t0 = time.perf_counter()
    rgb = full_render.render_image(
        model, ref_info, data["que_imgs_info"]["c2w"], qdr, args.chunk,
        ref_data=encode_refs(model, ref_info), device=dev)["rgb"]
    synchronize(dev)
    dt = time.perf_counter() - t0
    gt = s["rgb_panos"][imgs_info.QUE_ID]
    m = {k: float(v) for k, v in M.render_metrics(rgb, gt).items()}
    m["sec_per_frame"] = dt
    save_image(out_dir / "que-nr_fine.png", rgb.cpu().numpy())
    save_image(out_dir / "que-gt.png", gt.cpu().numpy())
    (out_dir / "metric.txt").write_text(json.dumps(m, indent=2))
    print(json.dumps(m))
    return m


if __name__ == "__main__":
    main()
