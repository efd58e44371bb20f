"""The multi-view traffic's scenes, drawn from a seed.

The room and its spheres are ``scenes.py``'s (``sphere_scene`` and its
ray tracer, imported, not copied): ``views`` panoramas ``spacing`` apart
along a shared camera z axis, centred on a random base point, with a
random common yaw, as the port's ``data/synthetic.make_multi_view_sample``
lays them out.  The multi-view model's protocol: the references are
views 0 to ``views - 2`` and the last view is held out as the query.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench import scenes
from h100bench.reference.core.sphere import get_convention


def multi_view(scene_seed: int, pose_seed: int, height: int, width: int,
               spacing: float, views: int, device) -> dict:
    """``views`` panoramas of one scene: ``rgb_panos`` (V, H, W, 3),
    ``depth_panos`` (V, H, W, 1), ``rots`` (V, 3, 3) and ``trans`` (V, 3)
    world-to-camera."""
    scene = scenes.sphere_scene(scene_seed, device)
    rng = np.random.default_rng(pose_seed)
    yaw = rng.uniform(0, 2 * np.pi)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot_c2w = torch.as_tensor([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]],
                              dtype=torch.float32, device=device)
    base = torch.as_tensor(rng.uniform(-1.0, 1.0, size=3),
                           dtype=torch.float32, device=device)
    z_axis = rot_c2w[:, 2]
    dirs_cam = get_convention("m3d").ray_directions(height, width, device)
    dirs_w = torch.einsum("ij,hwj->hwi", rot_c2w, dirs_cam)
    rgbs, depths, trans = [], [], []
    for off in (np.arange(views) - (views - 1) / 2.0) * spacing:
        p = base + float(off) * z_axis
        rgb, t = scenes._trace(scene, p, dirs_w)
        rgbs.append(rgb)
        depths.append(t[..., None])
        trans.append(-rot_c2w.T @ p)
    return {"rgb_panos": torch.stack(rgbs),
            "depth_panos": torch.stack(depths),
            "rots": rot_c2w.T.expand(views, 3, 3).contiguous(),
            "trans": torch.stack(trans)}


def other_refs(ref_ids) -> list:
    """The sources of each reference: every other reference."""
    return [[r for r in ref_ids if r != ref] for ref in ref_ids]


def scene_inputs(sample: dict, ref_ids, query: int) -> dict:
    """The stack's and the renderer's inputs: ``ref_imgs`` (R, H, W, 3),
    ``src_imgs`` (R, S, H, W, 3) with each reference's S sources,
    ``ref_w2c`` (R, 3, 4), ``src_w2c`` (R, S, 3, 4), and ``c2w`` (V, 3, 4)
    of every view (the query's among them)."""
    w2c = scenes.pose_w2c(sample["rots"], sample["trans"])
    ref = list(ref_ids)
    src = torch.as_tensor(other_refs(ref), device=w2c.device)
    if not 0 <= query < w2c.shape[0] or query in ref:
        raise ValueError(f"query view {query} is not a held-out view")
    return {"ref_imgs": sample["rgb_panos"][ref],
            "src_imgs": sample["rgb_panos"][src],
            "ref_w2c": w2c[ref], "src_w2c": w2c[src],
            "c2w": scenes.c2w_from_w2c(w2c)}
