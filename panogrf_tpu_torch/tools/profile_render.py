"""Component timing of the 512x1024 render path on one GPU.

    python -m panogrf_tpu_torch.tools.profile_render [--device cpu]

Port of the repo's ``tools/profile_render.py``, with its stages and JSON
keys: a 512x1024 renderer at its default flags (float32, hierarchical
sampling, the per-map gathers) with 256x512 reference depth, 2 reference
views, one chunk of 8192 rays and 64 samples, random inputs from seed 0
and random weights:

* ``prepare_ref_ms``: the per-scene encoding of the two views;
* ``render_8192rays_ms``: ``render_rays`` on the chunk, coarse and fine
  passes (two ``mlp2`` launches);
* ``project_gather_ms``: sample depths, points and the projection and
  fetch of every (sample, view) alone;
* ``agg_net_ms``: the aggregation net alone on the chunk's (1, 8192, 64,
  2, C) point-major inputs of ones (one ``mlp2`` launch).  The JAX tool
  passes view-major (2, 1, 8192, 64, C) arrays, which its net reads as 64
  views of 8192-sample rays; the port times the chunk's own work;
* ``dist_decoder_ms``: the mixture decoder alone on those points;
* ``raw_gathers_ms``: three bilinear fetches (ray features, images, image
  features) of 2 x 8192 x 64 random points;
* ``est_frame_ms_from_chunks``: ``render_8192rays_ms`` times the frame's
  64 chunks.

Each stage is timed as the JAX tool times it, per call: the least of 5
calls after a warm-up, each bracketed by CUDA events and waited for (the
host clock on the CPU), so a stage's host cost counts.  The JSON also
carries ``device``, ``tf32`` and each stage's ``mlp2`` launches per call.
It runs on the CUDA device and raises without one unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from panogrf_tpu_torch.ops.resample import interpolate_feats
from panogrf_tpu_torch.renderer import render_ops as ro
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.tools._stage_timer import (device_name, mlp2_launches,
                                                  tf32_on)
from panogrf_tpu_torch.tools.bench import timed_runs
from panogrf_tpu_torch.tools.profile_honest import dir_diff
from panogrf_tpu_torch.utils.device import resolve_device

RFN, DN = 2, 64
SIZE = (512, 1024, 256, 512)      # H, W, depth H, depth W
RAYS = 8192


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def render_inputs(size: tuple = SIZE, rays: int = RAYS, dn: int = DN) -> dict:
    """The JAX tool's random inputs as numpy (seed 0, its order)."""
    h, w, dh, dw = size
    rng = np.random.default_rng(0)
    w2c = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1),
                  (RFN, 1, 1))
    w2c[1, 2, 3] = 1.0
    x = {"imgs": rng.uniform(size=(RFN, h, w, 3)),
         "mvs_depth": rng.uniform(1, 6, size=(RFN, dh, dw, 1)), "w2c": w2c}
    x["coords"] = np.stack([rng.integers(0, w, (1, rays)),
                            rng.integers(0, h, (1, rays))], -1)
    x["pts"] = rng.uniform(0, 500, size=(RFN, rays * dn, 2))
    return x


def render_stages(dev: torch.device, size: tuple = SIZE, rays: int = RAYS,
                  dn: int = DN) -> tuple:
    """(model, {key: fn}): each fn runs its stage once and returns its
    outputs; ``prepare_ref_ms`` first (the others read its maps)."""
    h, w, dh, dw = size
    x = render_inputs(size, rays, dn)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev)
    model = NeuralRayGenRenderer(
        height=h, width=w, depth_hw=(dh, dw), depth_sample_num=dn,
        fine_depth_sample_num=dn, device=dev,
        generator=torch.Generator().manual_seed(0)).eval()
    imgs, mvs_depth, coords = t(x["imgs"]), t(x["mvs_depth"]), t(x["coords"])
    c2w = t([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0.5]])
    qdr = t([[0.5, 15.0]])
    rdr = t([[0.5, 15.0]] * RFN)
    ref = {}

    def prepare():
        ref.update(model.prepare_ref(imgs, mvs_depth), w2c=t(x["w2c"]))
        return ref

    def render():
        return model.render_rays(ref, coords, c2w, qdr, rdr)

    def project_gather():
        qd, _ = ro.sample_depth(1, rays, dn, 0.5, 15.0, True, dev)
        pts, que_dir = ro.depth2points_spherical(coords, qd, c2w,
                                                 model.directions)
        return ro.project_points_dict(ref, pts, model.convention,
                                      que_dir)["ray_feats"]

    ones = torch.ones(1, rays, dn, RFN, 32, device=dev)
    prj = {"ray_feats": ones, "rgb": ones[..., :3], "img_feats": ones,
           "hit_prob": ones[..., :1], "vis": ones[..., :1]}
    que_dir = ones[..., 0, :3]

    def agg():
        return model.agg_net({**prj, "dir_diff": dir_diff(prj["rgb"],
                                                          que_dir)})
    pts = t(x["pts"])

    def gathers():
        return sum(interpolate_feats(ref[k], pts, h, w).sum()
                   for k in ("ray_feats", "imgs", "img_feats"))

    return model, {"prepare_ref_ms": prepare, "render_8192rays_ms": render,
                   "project_gather_ms": project_gather,
                   "agg_net_ms": agg,
                   "dist_decoder_ms": lambda: model.dist_decoder(ones),
                   "raw_gathers_ms": gathers}


def main(argv=None) -> dict:
    """Profile the stages; prints the JSON and returns it."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    res, launches = {}, {}
    with torch.inference_mode():
        _, stages = render_stages(dev, SIZE, RAYS)
        for key, fn in stages.items():
            print(f"[stage] {key} ...", flush=True)
            launches[key] = mlp2_launches(fn)
            res[key] = min(timed_runs(lambda i: fn(), dev, runs=5))
    h, w = SIZE[:2]
    res["est_frame_ms_from_chunks"] = \
        res["render_8192rays_ms"] * (h * w / RAYS)
    res.update(device=device_name(dev), tf32=tf32_on(),
               mlp2_launches=launches)
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
