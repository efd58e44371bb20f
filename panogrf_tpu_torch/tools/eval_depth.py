"""Score the mono and MVS depth of the depth stack on evaluation scenes.

    python -m panogrf_tpu_torch.tools.eval_depth [--num 4] \\
        [--height 256 --width 512] [--mono-ckpt F] [--mvs-ckpt F] \\
        [--device cpu]

Port of the repo's ``tools/eval_depth.py``: for each of ``--num``
procedural 3-view scenes (scene seed 4000 + i, pose seed 200 + i) the
stack predicts the reference view's depth from the (source, reference)
pair at ``--height`` x ``--width``: UniFuse alone (``mono``) and the MVS
net on its prior (``mvs``).  It prints the sin-weighted ERP metric table
of both (``train/metrics.depth_metrics_erp``, mean over the scenes) as
JSON.  Weights come from ``train_mono``/``train_depth`` checkpoint files
(``.pth``; the mono net from ``--mono-ckpt``, else from the MVS file's
``d_net.*``, else random) or the JAX depth trainers' orbax directories,
as ``models/depth_stack.load_depth_stack`` reads them.  It runs on the
CUDA device and raises without one unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from panogrf_tpu_torch.data.imgs_info import pose_w2c
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_three_view_sample)
from panogrf_tpu_torch.models.depth_stack import load_depth_stack
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num", type=int, default=4)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--m3d-dist", type=float, default=1.0)
    ap.add_argument("--mono-ckpt", default=None,
                    help="UniFuse checkpoint file, or an orbax directory "
                         "of the JAX trainer")
    ap.add_argument("--mvs-ckpt", default=None,
                    help="MVS checkpoint file, or an orbax directory of "
                         "the JAX trainer")
    ap.add_argument("--min-depth", type=float, default=0.1)
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the CLI on ``argv``; returns the printed table."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    H, W = args.height, args.width
    stack = load_depth_stack(
        args.mono_ckpt, args.mvs_ckpt, mono_hw=(H, W), depth_hw=(H, W),
        max_depth=args.max_depth,
        mvs_kwargs={"min_depth": args.min_depth},
        random_mvs=True, device=dev)
    agg = {"mono": [], "mvs": []}
    for qi in range(args.num):
        s = make_three_view_sample(SphereScene.random(4000 + qi, device=dev),
                                   H, W, args.m3d_dist, seed=200 + qi)
        gt = torch.clamp(s["depth_panos"][1], 0, args.max_depth)
        w2c = pose_w2c(s["rots"], s["trans"])
        out = stack(s["rgb_panos"][1:2], s["rgb_panos"][0:1], w2c[1:2],
                    w2c[0:1])
        for net, key in (("mono", "mono_depth"), ("mvs", "mvs_depth")):
            agg[net].append({k: float(v) for k, v in M.depth_metrics_erp(
                out[key][0], gt, args.min_depth, args.max_depth).items()})
    table = {net: {k: round(float(np.mean([m[k] for m in ms])), 4)
                   for k in ms[0]} for net, ms in agg.items()}
    print(json.dumps(table, indent=1))
    return table


if __name__ == "__main__":
    main()
