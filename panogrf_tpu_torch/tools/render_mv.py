"""Multi-view novel-view rendering with its metrics.

    python -m panogrf_tpu_torch.tools.render_mv [--ckpt model.pth] \\
        [--views V] [--que-idx Q] [--num N] [--height H --width W] \\
        [--depth-height DH --depth-width DW] [--spacing S] [--chunk C] \\
        [--out DIR] [--device cpu]

Port of the repo's ``tools/render_mv.py``.  Each of ``--num`` procedural
scenes has ``--views`` views ``--spacing`` apart along one axis; the view
``--que-idx`` is rendered from all the others, at their true depth,
through ``full_render.render_image`` (``--chunk`` rays per pass, float32,
the renderer's exact flags), and ``<i>-nr_fine.png``, ``<i>-gt.png`` and
``metric.txt`` (the mean PSNR / SSIM / WS-PSNR and seconds per frame)
are written under ``--out``.  ``--ckpt`` is a renderer ``model.pth`` in
the reference layout, which the port's training CLI writes; without it
the weights are random.  It runs on the CUDA device and raises without
one unless ``--device cpu`` is given.
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
                                              make_multi_view_sample)
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.tools.render import save_image
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.train.trainer import load_checkpoint_params
from panogrf_tpu_torch.utils.device import resolve_device, synchronize


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--views", type=int, default=5)
    ap.add_argument("--que-idx", type=int, default=2,
                    help="query view index (the middle one by default)")
    ap.add_argument("--num", type=int, default=2)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--depth-height", type=int, default=128)
    ap.add_argument("--depth-width", type=int, default=256)
    ap.add_argument("--spacing", type=float, default=0.4)
    ap.add_argument("--out", default="data/render_mv_out")
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool on ``argv``; returns the per-frame metrics and their
    mean."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    dh, dw = args.depth_height, args.depth_width
    model = NeuralRayGenRenderer(height=h, width=w, depth_hw=(dh, dw),
                                 device=dev,
                                 generator=torch.Generator().manual_seed(0))
    if args.ckpt:
        model.load_state_dict(load_checkpoint_params(args.ckpt))
        print(f"restored {args.ckpt}")
    model.eval()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    ref_ids = [i for i in range(args.views) if i != args.que_idx]
    coords = imgs_info.sample_train_coords(np.random.default_rng(0), h, w, 8,
                                           device=dev)
    frames = []
    for qi in range(args.num):
        s = make_multi_view_sample(SphereScene.random(7000 + qi, device=dev),
                                   h, w, args.views, args.spacing,
                                   seed=300 + qi)
        data = imgs_info.build_render_sample_mv(s, coords, ref_ids,
                                                args.que_idx)
        ref_info = data["ref_imgs_info"]
        ref_info["mvs_depth"] = resize_linear(s["depth_panos"][ref_ids],
                                              (dh, dw), axes=(1, 2))
        synchronize(dev)
        t0 = time.perf_counter()
        rgb = full_render.render_image(
            model, ref_info, data["que_imgs_info"]["c2w"],
            data["que_imgs_info"]["depth_range"],
            chunk=min(args.chunk, h * w), device=dev)["rgb"]
        synchronize(dev)
        dt = time.perf_counter() - t0
        gt = s["rgb_panos"][args.que_idx]
        m = {k: float(v) for k, v in M.render_metrics(rgb, gt).items()}
        m["sec_per_frame"] = dt
        frames.append(m)
        save_image(out_dir / f"{qi}-nr_fine.png", rgb.cpu().numpy())
        save_image(out_dir / f"{qi}-gt.png", gt.cpu().numpy())
        print(f"[{qi}] refs={ref_ids} "
              + " ".join(f"{k}={v:.3f}" for k, v in m.items()))
    mean = {k: float(np.mean([m[k] for m in frames])) for k in frames[0]}
    (out_dir / "metric.txt").write_text(json.dumps(mean, indent=2))
    print("mean:", json.dumps(mean))
    return {"frames": frames, "mean": mean}


if __name__ == "__main__":
    main()
