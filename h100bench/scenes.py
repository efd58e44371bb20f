"""The traffic's scenes and camera paths, drawn from a seed.

Frozen from the port's ``data/synthetic.py`` (``SphereScene``,
``make_three_view_sample``), ``data/imgs_info.py`` (the 3-view protocol's
view ids and pose helpers) and ``renderer/poses.py`` (the render CLI's
'inter' path) at the commit named in ``README.md``, so that a later
change to the port cannot change the traffic.  A textured room sphere
holds 12 lambertian spheres, ray-traced in torch on the given device, with
exact distance depth; three views lie on a line with a random common yaw.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench.reference.core.sphere import get_convention

REF_IDS = (0, 2)
SRC_IDS = (2, 0)
_LIGHT = np.asarray([0.4, 0.8, 0.45])


def sphere_scene(seed: int, device, num: int = 12,
                 room_radius: float = 8.0) -> dict:
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(num, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radii = rng.uniform(0.4, 1.2, size=(num,))
    dist = rng.uniform(2.2, 5.5, size=(num,)) + radii
    centers = dirs * dist[:, None]
    colors = rng.uniform(0.1, 1.0, size=(num, 3))

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)
    return {"centers": t(centers), "radii": t(radii), "colors": t(colors),
            "room_radius": room_radius}


def _ray_sphere(origin, dirs, center, radius):
    oc = origin - center
    b = torch.sum(dirs * oc, -1)
    c = torch.sum(oc * oc, -1) - radius ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 > 1e-3, t0, t1)
    return torch.where((disc > 0) & (t > 1e-3), t,
                       torch.full_like(t, float("inf")))


def _room_texture(dirs):
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    r = 0.5 + 0.25 * torch.sin(3.0 * x + 1.0) + 0.25 * torch.sin(5.0 * z)
    g = 0.5 + 0.25 * torch.sin(4.0 * y + 2.0) + 0.25 * torch.cos(3.0 * x)
    b = 0.5 + 0.25 * torch.cos(2.0 * z + 0.5) + 0.25 * torch.sin(4.0 * y)
    return torch.clamp(torch.stack([r, g, b], -1), 0.0, 1.0)


def _trace(scene: dict, cam_pos, dirs_w) -> tuple:
    c, r = scene["centers"], scene["radii"]
    ts = _ray_sphere(cam_pos, dirs_w[None], c[:, None, None],
                     r[:, None, None])
    t_room = _ray_sphere(cam_pos, dirs_w, torch.zeros_like(cam_pos),
                         scene["room_radius"])
    t, idx = torch.min(torch.cat([ts, t_room[None]], 0), 0)
    hit = cam_pos + dirs_w * t[..., None]
    normals = (hit[None] - c[:, None, None]) / r[:, None, None, None]
    light = torch.as_tensor(_LIGHT / np.linalg.norm(_LIGHT),
                            dtype=torch.float32, device=dirs_w.device)
    shade = 0.55 + 0.45 * torch.clamp(
        torch.einsum("nhwi,i->nhw", normals, light), 0.0, 1.0)
    obj = scene["colors"][:, None, None, :] * shade[..., None]
    all_rgb = torch.cat([obj, _room_texture(dirs_w)[None]], 0)
    rgb = torch.gather(all_rgb, 0, idx[None, ..., None].expand(
        1, *idx.shape, 3))[0]
    return rgb, t


def three_view(scene_seed: int, pose_seed: int, height: int, width: int,
               m3d_dist: float, device) -> dict:
    """Three views at -m3d_dist, 0, +m3d_dist along a shared camera z
    axis: ``rgb_panos`` (3, H, W, 3), ``depth_panos`` (3, H, W, 1),
    ``rots`` (3, 3, 3) and ``trans`` (3, 3) world-to-camera."""
    scene = sphere_scene(scene_seed, device)
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
    for p in (base - m3d_dist * z_axis, base, base + m3d_dist * z_axis):
        rgb, t = _trace(scene, p, dirs_w)
        rgbs.append(rgb)
        depths.append(t[..., None])
        trans.append(-rot_c2w.T @ p)
    return {"rgb_panos": torch.stack(rgbs),
            "depth_panos": torch.stack(depths),
            "rots": rot_c2w.T.expand(3, 3, 3).contiguous(),
            "trans": torch.stack(trans)}


def pose_w2c(rots: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    return torch.cat([rots, trans[..., None]], -1)


def c2w_from_w2c(w2c: torch.Tensor) -> torch.Tensor:
    rot = w2c[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", rot, w2c[..., :3, 3])
    return torch.cat([rot, t[..., None]], -1)


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def _quat_to_rot(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def inter_path(c2w_a: np.ndarray, c2w_b: np.ndarray, num: int) -> np.ndarray:
    """The render CLI's ``--pose-type inter`` path: (num, 3, 4) poses
    from ``c2w_a`` to ``c2w_b``, rotations slerped, positions lerped."""
    qa, qb = _rot_to_quat(c2w_a[:, :3]), _rot_to_quat(c2w_b[:, :3])
    poses = []
    for t in np.linspace(0.0, 1.0, num):
        r = _quat_to_rot(_slerp(qa, qb, float(t)))
        p = (1 - t) * c2w_a[:, 3] + t * c2w_b[:, 3]
        poses.append(np.concatenate([r, p[:, None]], 1))
    return np.stack(poses).astype(np.float32)
