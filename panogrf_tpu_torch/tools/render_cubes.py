"""Render the perspective cube faces of a query view, with their metrics.

    python -m panogrf_tpu_torch.tools.render_cubes [--ckpt model.pth] \\
        [--num N] [--height H --width W] \\
        [--depth-height DH --depth-width DW] [--shards DIR] [--out DIR] \\
        [--device cpu]

Port of the repo's ``tools/render_cubes.py``.  For each of ``--num``
procedural 3-view scenes the six 90-degree cube faces (H/2 x H/2 pixels)
of the query view are rendered through the two spherical reference views
(``render_rays`` with ``perspec_cam``, the renderer's exact flags, the
references at their true depth) and scored against the faces that
``core/cubemap.equi_to_cube`` cuts from the query panorama.  Each face
renders in chunks of 4096 rays, which only blocks the work.  Writes
``<i>-face<f>-pred.npy`` and ``metric.txt`` (the mean PSNR / SSIM /
WS-PSNR) under ``--out``.  ``--ckpt`` is a renderer ``model.pth`` in the
reference layout, which the port's training CLI writes; without it the
weights are random.  With ``--shards`` the scenes are the first
``--num`` samples of a shard directory; where they carry cube faces
(``prepare_data --cubes``, imported reference data) the stored query
faces are the ground truth and their stored poses ``[rots_cubes |
trans_cubes]`` the face cameras, with the intrinsics of the stored face
width, which must be ``--height`` / 2.  It runs on the CUDA device and
raises without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from panogrf_tpu_torch.core import cubemap
from panogrf_tpu_torch.data import imgs_info
from panogrf_tpu_torch.data.database import PanoDatabase, cube_intrinsics
from panogrf_tpu_torch.data.shards import ShardReader, sample_to_torch
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_three_view_sample)
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.train.trainer import load_checkpoint_params
from panogrf_tpu_torch.utils.device import resolve_device, synchronize

CHUNK = 4096


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--num", type=int, default=1)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--depth-height", type=int, default=128)
    ap.add_argument("--depth-width", type=int, default=256)
    ap.add_argument("--m3d-dist", type=float, default=0.5)
    ap.add_argument("--out", default="data/render_cubes_out")
    ap.add_argument("--shards", default=None,
                    help="render the first --num samples of this shard "
                         "directory; stored cube faces are the ground truth")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


@torch.inference_mode()
def render_face(model: NeuralRayGenRenderer, ref_data: dict, coords,
                w2c_face: torch.Tensor, k: torch.Tensor, qdr,
                ref_depth_range, face_w: int) -> torch.Tensor:
    """One cube face (face_w, face_w, 3) in [0, 1], ``CHUNK`` rays at a
    time; ``coords`` (1, face_w**2, 2), ``qdr`` the query's (1, 2) depth
    range."""
    cam = (w2c_face[None], k[None])
    rgb = [model.render_rays(ref_data, coords[:, i:i + CHUNK], None, qdr,
                             ref_depth_range, perspec_cam=cam)
           for i in range(0, coords.shape[1], CHUNK)]
    key = "pixel_colors_nr_fine" if "pixel_colors_nr_fine" in rgb[0] \
        else "pixel_colors_nr"
    return torch.clamp(torch.cat([o[key][0] for o in rgb]).reshape(
        face_w, face_w, 3), 0.0, 1.0)


def main(argv=None) -> dict:
    """Run the tool on ``argv``; returns the per-face metrics, their mean
    and the seconds per face."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    dh, dw = args.depth_height, args.depth_width
    fw = h // 2
    model = NeuralRayGenRenderer(height=h, width=w, depth_hw=(dh, dw),
                                 device=dev,
                                 generator=torch.Generator().manual_seed(0))
    if args.ckpt:
        model.load_state_dict(load_checkpoint_params(args.ckpt))
        print(f"restored {args.ckpt}")
    model.eval()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    ys, xs = torch.meshgrid(torch.arange(fw, device=dev),
                            torch.arange(fw, device=dev), indexing="ij")
    face_coords = torch.stack([xs, ys], -1).reshape(1, -1, 2).float()
    coords8 = imgs_info.sample_train_coords(np.random.default_rng(0), h, w,
                                            8, device=dev)
    reader = ShardReader(args.shards) if args.shards else None
    num = min(args.num, len(reader)) if reader is not None else args.num
    metrics, seconds = [], []
    for qi in range(num):
        if reader is not None:
            s = sample_to_torch(reader[qi], dev)
        else:
            s = make_three_view_sample(
                SphereScene.random(8800 + qi, device=dev), h, w,
                args.m3d_dist, seed=50 + qi)
        db = PanoDatabase("m3d", *(s[k].cpu().numpy() for k in (
            "rgb_panos", "depth_panos", "rots", "trans")))
        data = imgs_info.build_render_sample(s, coords8)
        ref_info = data["ref_imgs_info"]
        ref_ids = list(imgs_info.REF_IDS)
        with torch.inference_mode():
            ref_data = model.prepare_ref(
                ref_info["imgs"], resize_linear(s["depth_panos"][ref_ids],
                                                (dh, dw), axes=(1, 2)))
        ref_data["w2c"] = ref_info["w2c"]
        q = imgs_info.QUE_ID
        if "rgb_cubes" in s:
            # stored faces are the ground truth, their stored poses the
            # cameras, K that of the stored face width
            gt_cube = s["rgb_cubes"][q]
            cw = gt_cube.shape[1]
            if cw != fw:
                raise SystemExit(f"--height {h} implies face width {fw} but "
                                 f"shards store {cw}; pass --height "
                                 f"{cw * 2}")
            w2c_faces = torch.cat([s["rots_cubes"][q],
                                   s["trans_cubes"][q][..., None]], -1)
            k = torch.as_tensor(cube_intrinsics(cw), device=dev)
        else:
            w2c_faces, k = (torch.as_tensor(a, device=dev)
                            for a in db.cube_cameras(q))
            gt_cube = cubemap.equi_to_cube(s["rgb_panos"][q][None], fw)[0]
        for f in range(6):
            synchronize(dev)
            t0 = time.perf_counter()
            pred = render_face(model, ref_data, face_coords, w2c_faces[f], k,
                               data["que_imgs_info"]["depth_range"],
                               ref_info["depth_range"], fw)
            synchronize(dev)
            seconds.append(time.perf_counter() - t0)
            metrics.append({key: float(v) for key, v in
                            M.render_metrics(pred, gt_cube[f]).items()})
            np.save(out_dir / f"{qi}-face{f}-pred.npy", pred.cpu().numpy())
        print(f"[{qi}] face psnr:",
              [round(m["psnr_nr"], 2) for m in metrics[-6:]])
    mean = {key: float(np.mean([m[key] for m in metrics]))
            for key in metrics[0]}
    (out_dir / "metric.txt").write_text(json.dumps(mean, indent=2))
    print("mean:", json.dumps(mean))
    return {"faces": metrics, "mean": mean,
            "sec_per_face": float(np.mean(seconds))}


if __name__ == "__main__":
    main()
