"""Multi-view novel-view rendering with its metrics.

    python -m panogrf_tpu_torch.tools.render_mv [--ckpt model.pth] \\
        [--views V] [--que-idx Q] [--num N] [--height H --width W] \\
        [--depth-height DH --depth-width DW] [--spacing S] [--chunk C] \\
        [--depth-stack | --mono-ckpt F --mvs-ckpt F] \\
        [--preset serving [--frame-batch B]] [--out DIR] [--device cpu]

Port of the repo's ``tools/render_mv.py``.  Each of ``--num`` procedural
scenes has ``--views`` views ``--spacing`` apart along one axis; the view
``--que-idx`` is rendered from all the others.  By default the references
are at their true depth and the query renders through
``full_render.render_image`` (``--chunk`` rays per pass, float32, the
renderer's exact flags).  ``<i>-nr_fine.png``, ``<i>-gt.png`` and
``metric.txt`` (the mean PSNR / SSIM / WS-PSNR and seconds per frame) are
written under ``--out``.  ``--ckpt`` is a renderer ``model.pth`` in the
reference layout, which the port's training CLI writes, or an orbax
directory of the JAX trainer; without it the weights are random.

``--depth-stack``, ``--mono-ckpt`` and ``--mvs-ckpt`` take each
reference's depth from the frozen depth stack instead, as the multi-view
model computes it: each reference is swept against every other reference
(``depth_stack.other_refs``) and the MVS net averages their costs; no
true depth is read.  Checkpoints are read as ``tools/render.py`` reads
them; the nets without one have random weights.

``--preset serving`` builds the renderer at the serving preset's flags
and draws each scene's frames through ``full_render.render_video_device``:
``--frame-batch`` B poses in one pass, on the path from the first
reference to the query, whose last pose is the query (B = 1: the query
alone).  Every frame is written as ``<i>-frame<k>.png``, and the query's
is scored.  ``--chunk`` is then the preset's unless given.

It runs on the CUDA device and raises without one unless ``--device cpu``
is given (on the CPU the preset computes in float32).
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
from panogrf_tpu_torch.models.depth_stack import (load_depth_stack,
                                                  other_refs,
                                                  stack_depth_for_sample)
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer import poses as P
from panogrf_tpu_torch.renderer.presets import (PRESET_CHUNK,
                                                PRESET_COARSE_CHUNK,
                                                PRESET_COARSE_LOWRES,
                                                preset_kwargs)
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.tools.render import save_image
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.train.trainer import load_checkpoint_params
from panogrf_tpu_torch.utils.device import resolve_device, synchronize


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="renderer model.pth, or an orbax directory of "
                         "the JAX trainer")
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
    ap.add_argument("--chunk", type=int, default=0,
                    help="rays per chunk pass (0 = 2048, or the preset's)")
    ap.add_argument("--mono-ckpt", default=None,
                    help="UniFuse checkpoint (reference-layout file, or "
                         "an orbax directory of the JAX trainer)")
    ap.add_argument("--mvs-ckpt", default=None,
                    help="MVS checkpoint (reference-layout file, or an "
                         "orbax directory of the JAX trainer)")
    ap.add_argument("--depth-stack", action="store_true",
                    help="references' depth from the multi-source depth "
                         "stack (random weights without checkpoints)")
    ap.add_argument("--preset", default=None,
                    choices=["serving"],
                    help="render through render_video_device at this "
                         "preset's flags")
    ap.add_argument("--frame-batch", type=int, default=1,
                    help="with --preset: poses per pass, on the path from "
                         "the first reference to the query")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the tool on ``argv``; returns the per-frame metrics and their
    mean, and with the depth stack its nets and seconds per scene."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    h, w = args.height, args.width
    dh, dw = args.depth_height, args.depth_width
    kw = {}
    if args.preset:
        kw = preset_kwargs(args.preset, compute_dtype="float32"
                           if dev.type == "cpu" else None)
    model = NeuralRayGenRenderer(height=h, width=w, depth_hw=(dh, dw), **kw,
                                 device=dev,
                                 generator=torch.Generator().manual_seed(0))
    if args.ckpt:
        model.load_state_dict(load_checkpoint_params(args.ckpt))
        print(f"restored {args.ckpt}")
    model.eval()
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    ref_ids = [i for i in range(args.views) if i != args.que_idx]
    summary = {"frames": [], "stack_seconds": []}
    stack = None
    if args.depth_stack or args.mono_ckpt or args.mvs_ckpt:
        stack = load_depth_stack(
            args.mono_ckpt, args.mvs_ckpt,
            # UniFuse's cube fusion needs W >= 128 (1/32-scale ERP)
            mono_hw=(max(h, 64), max(w, 128)),
            # the MVS UNet needs >= 32 rows; its depth is resized to DH, DW
            depth_hw=(max(dh, 32), max(dw, 64)), random_mvs=True,
            device=dev)
        summary["depth_stack"] = {"mono": args.mono_ckpt or "random",
                                  "mvs": args.mvs_ckpt or "random",
                                  "sources": other_refs(ref_ids)}
        print(f"depth stack: mono={args.mono_ckpt or 'random'} "
              f"mvs={args.mvs_ckpt or 'random'}, sources "
              f"{other_refs(ref_ids)}")
    chunk = args.chunk or (PRESET_CHUNK[args.preset] if args.preset
                           else 2048)
    if args.preset:
        clr = PRESET_COARSE_LOWRES[args.preset]
        if h % clr or w % clr:
            clr = 1
        while (h * w) % chunk:
            chunk //= 2
    coords = imgs_info.sample_train_coords(np.random.default_rng(0), h, w, 8,
                                           device=dev)
    for qi in range(args.num):
        s = make_multi_view_sample(SphereScene.random(7000 + qi, device=dev),
                                   h, w, args.views, args.spacing,
                                   seed=300 + qi)
        data = imgs_info.build_render_sample_mv(s, coords, ref_ids,
                                                args.que_idx)
        ref_info = data["ref_imgs_info"]
        if stack is not None:
            synchronize(dev)
            t0 = time.perf_counter()
            pred = stack_depth_for_sample(stack, s, ref_ids,
                                          other_refs(ref_ids))
            synchronize(dev)
            summary["stack_seconds"].append(time.perf_counter() - t0)
            depth = pred["mvs_depth"]
        else:
            depth = s["depth_panos"][ref_ids]
        ref_info["mvs_depth"] = resize_linear(depth, (dh, dw), axes=(1, 2))
        synchronize(dev)
        t0 = time.perf_counter()
        if args.preset:
            ref_data = full_render.prepare_ref_data(model, ref_info,
                                                    device=dev)
            rgbs = full_render.render_video_device(
                model, ref_data, _path(s, ref_ids[0], args.que_idx,
                                       args.frame_batch),
                data["que_imgs_info"]["depth_range"],
                ref_info["depth_range"], chunk=chunk, coarse_lowres=clr,
                coarse_chunk=PRESET_COARSE_CHUNK[args.preset], device=dev)
            rgb = rgbs[-1]
        else:
            rgb = full_render.render_image(
                model, ref_info, data["que_imgs_info"]["c2w"],
                data["que_imgs_info"]["depth_range"],
                chunk=min(chunk, h * w), device=dev)["rgb"]
        synchronize(dev)
        dt = time.perf_counter() - t0
        gt = s["rgb_panos"][args.que_idx]
        m = {k: float(v) for k, v in M.render_metrics(rgb.float(),
                                                      gt).items()}
        m["sec_per_frame"] = dt / (len(rgbs) if args.preset else 1)
        summary["frames"].append(m)
        if args.preset:
            for k, f in enumerate(rgbs):
                save_image(out_dir / f"{qi}-frame{k:03d}.png",
                           f.float().cpu().numpy())
        save_image(out_dir / f"{qi}-nr_fine.png", rgb.float().cpu().numpy())
        save_image(out_dir / f"{qi}-gt.png", gt.cpu().numpy())
        print(f"[{qi}] refs={ref_ids} "
              + " ".join(f"{k}={v:.3f}" for k, v in m.items()))
    frames = summary["frames"]
    mean = {k: float(np.mean([m[k] for m in frames])) for k in frames[0]}
    (out_dir / "metric.txt").write_text(json.dumps(mean, indent=2))
    print("mean:", json.dumps(mean))
    return {**summary, "mean": mean}


def _path(s: dict, first: int, query: int, n: int) -> np.ndarray:
    """``n`` poses (n, 3, 4) from view ``first`` to view ``query`` of the
    sample ``s``, the query last (n = 1: the query alone)."""
    c2w = imgs_info.c2w_from_w2c(imgs_info.pose_w2c(s["rots"], s["trans"]))
    c2w = c2w.cpu().numpy()
    if n <= 1:
        return c2w[query][None]
    return P.interpolate_c2w(c2w[first], c2w[query], n)


if __name__ == "__main__":
    main()
