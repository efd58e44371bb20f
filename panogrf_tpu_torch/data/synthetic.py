"""Procedural panoramic scenes for training and tests.

Port of the ERP half of ``panogrf_tpu/data/synthetic.py``: a textured room
sphere plus N lambertian spheres, ray-traced in torch on the given device,
with exact distance depth and full photo-consistency between views.  The
scene and the camera poses are drawn with numpy exactly as the JAX package
draws them, so a seed gives the same scene in both.  The 3-view sample
serves renderer and depth training, the V-view sample
(``make_multi_view_sample``) multi-view MVS training;
``render_cube_faces`` traces a view's six perspective cube faces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from panogrf_tpu_torch.core.sphere import SphereConvention, get_convention
from panogrf_tpu_torch.data.database import (cube_face_rotations,
                                             cube_intrinsics)

_LIGHT = np.asarray([0.4, 0.8, 0.45])


@dataclasses.dataclass(frozen=True)
class SphereScene:
    centers: torch.Tensor      # (N, 3)
    radii: torch.Tensor        # (N,)
    colors: torch.Tensor       # (N, 3)
    room_radius: float = 8.0

    @staticmethod
    def random(seed: int = 0, num: int = 12, room_radius: float = 8.0,
               device=None) -> "SphereScene":
        rng = np.random.default_rng(seed)
        # every sphere stays clear of the camera region (|p| <= ~1.8): a
        # camera inside an object would see its interior
        dirs = rng.normal(size=(num, 3))
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        radii = rng.uniform(0.4, 1.2, size=(num,))
        dist = rng.uniform(2.2, 5.5, size=(num,)) + radii
        centers = dirs * dist[:, None]
        colors = rng.uniform(0.1, 1.0, size=(num, 3))

        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)
        return SphereScene(t(centers), t(radii), t(colors), room_radius)


def _ray_sphere(origin: torch.Tensor, dirs: torch.Tensor,
                center: torch.Tensor, radius) -> torch.Tensor:
    """Nearest positive hit distance, inf on a miss; dirs unit (..., 3)."""
    oc = origin - center
    b = torch.sum(dirs * oc, -1)
    c = torch.sum(oc * oc, -1) - radius ** 2
    disc = b * b - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 > 1e-3, t0, t1)
    return torch.where((disc > 0) & (t > 1e-3), t,
                       torch.full_like(t, float("inf")))


def _room_texture(dirs: torch.Tensor) -> torch.Tensor:
    """Smooth periodic texture of the room sphere."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    r = 0.5 + 0.25 * torch.sin(3.0 * x + 1.0) + 0.25 * torch.sin(5.0 * z)
    g = 0.5 + 0.25 * torch.sin(4.0 * y + 2.0) + 0.25 * torch.cos(3.0 * x)
    b = 0.5 + 0.25 * torch.cos(2.0 * z + 0.5) + 0.25 * torch.sin(4.0 * y)
    return torch.clamp(torch.stack([r, g, b], -1), 0.0, 1.0)


def trace_rays(scene: SphereScene, cam_pos: torch.Tensor,
               dirs_w: torch.Tensor) -> tuple:
    """Trace unit world-frame rays (H, W, 3) against the scene.

    :return: (rgb (H, W, 3), distance (H, W)) — euclidean hit distance.
    """
    ts = _ray_sphere(cam_pos, dirs_w[None], scene.centers[:, None, None],
                     scene.radii[:, None, None])            # (N, H, W)
    t_room = _ray_sphere(cam_pos, dirs_w, torch.zeros_like(cam_pos),
                         scene.room_radius)
    all_t = torch.cat([ts, t_room[None]], 0)
    t, idx = torch.min(all_t, 0)                            # (H, W)

    hit_pts = cam_pos + dirs_w * t[..., None]
    normals = (hit_pts[None] - scene.centers[:, None, None]) \
        / scene.radii[:, None, None, None]
    light = torch.as_tensor(_LIGHT / np.linalg.norm(_LIGHT),
                            dtype=torch.float32, device=dirs_w.device)
    shade = 0.55 + 0.45 * torch.clamp(
        torch.einsum("nhwi,i->nhw", normals, light), 0.0, 1.0)
    obj_rgb = scene.colors[:, None, None, :] * shade[..., None]
    all_rgb = torch.cat([obj_rgb, _room_texture(dirs_w)[None]], 0)
    rgb = torch.gather(all_rgb, 0, idx[None, ..., None].expand(
        1, *idx.shape, 3))[0]
    return rgb, t


def render_panorama(scene: SphereScene, cam_pos: torch.Tensor,
                    cam_rot: torch.Tensor, height: int, width: int,
                    convention: SphereConvention | str = "m3d") -> tuple:
    """Ray-trace one ERP view.

    :param cam_pos: (3,) world position; cam_rot: (3, 3) world-from-camera
        rotation (c2w).
    :return: (rgb (H, W, 3), distance (H, W, 1)).
    """
    conv = get_convention(convention) if isinstance(convention, str) \
        else convention
    dirs_cam = conv.ray_directions(height, width, cam_pos.device)
    dirs_w = torch.einsum("ij,hwj->hwi", cam_rot, dirs_cam)
    rgb, t = trace_rays(scene, cam_pos, dirs_w)
    return rgb, t[..., None]


def render_cube_faces(scene: SphereScene, cam_pos: torch.Tensor,
                      cam_rot: torch.Tensor, face_w: int) -> tuple:
    """Ray-trace the six cube faces of a view: faces [F R B L U D] of
    ``core/cubemap.py``, each a 90-degree pinhole (``cube_intrinsics``)
    over the align-corners pixel grid.

    :param cam_pos: (3,); cam_rot: (3, 3) camera-to-world rotation of the
        panorama camera.
    :return: (rgb (6, fw, fw, 3), z-depth (6, fw, fw, 1): the distance
        along each face's optical axis).
    """
    dev = scene.centers.device
    k_inv = np.linalg.inv(cube_intrinsics(face_w))
    u, v = np.meshgrid(np.arange(face_w, dtype=np.float32),
                       np.arange(face_w, dtype=np.float32))
    dirs_face = np.einsum("ij,hwj->hwi", k_inv,
                          np.stack([u, v, np.ones_like(u)], -1))
    dirs_face /= np.linalg.norm(dirs_face, axis=-1, keepdims=True)
    dirs_cam = np.einsum("fij,hwj->fhwi", cube_face_rotations(), dirs_face)
    dirs_w = torch.einsum("ij,fhwj->fhwi", cam_rot, torch.as_tensor(
        dirs_cam, dtype=torch.float32, device=dev))
    rgb, t = trace_rays(scene, cam_pos,
                        dirs_w.reshape(6 * face_w, face_w, 3))
    cos_axis = torch.as_tensor(dirs_face[..., 2:3], dtype=torch.float32,
                               device=dev)
    return (rgb.reshape(6, face_w, face_w, 3),
            t.reshape(6, face_w, face_w, 1) * cos_axis)


def make_three_view_sample(scene: SphereScene, height: int, width: int,
                           m3d_dist: float = 0.5, seed: int = 0,
                           convention: str = "m3d") -> dict:
    """Three views offset by -m3d_dist, 0, +m3d_dist along a shared
    camera z axis with a random common yaw (the habitat 3-position
    protocol), rendered on the scene's device.

    :return: dict rgb_panos (3, H, W, 3), depth_panos (3, H, W, 1),
        rots (3, 3, 3) w2c, trans (3, 3) w2c.
    """
    dev = scene.centers.device
    rng = np.random.default_rng(seed)
    yaw = rng.uniform(0, 2 * np.pi)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot_c2w = torch.as_tensor([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]],
                              dtype=torch.float32, device=dev)
    base = torch.as_tensor(rng.uniform(-1.0, 1.0, size=3),
                           dtype=torch.float32, device=dev)
    z_axis = rot_c2w[:, 2]
    rgbs, depths, trans = [], [], []
    r_w2c = rot_c2w.T
    for p in (base - m3d_dist * z_axis, base, base + m3d_dist * z_axis):
        rgb, d = render_panorama(scene, p, rot_c2w, height, width,
                                 convention)
        rgbs.append(rgb)
        depths.append(d)
        # w2c: x_cam = R^T (x_w - p), so rot = R^T and t = -R^T p
        trans.append(-r_w2c @ p)
    return {"rgb_panos": torch.stack(rgbs),
            "depth_panos": torch.stack(depths),
            "rots": r_w2c.expand(3, 3, 3).contiguous(),
            "trans": torch.stack(trans)}


def make_multi_view_sample(scene: SphereScene, height: int, width: int,
                           num_views: int, spacing: float = 0.5,
                           seed: int = 0, convention: str = "m3d") -> dict:
    """``num_views`` views spaced ``spacing`` apart along a shared camera
    z axis, centred on a random base point, with a random common yaw;
    rendered on the scene's device.

    :return: dict rgb_panos (V, H, W, 3), depth_panos (V, H, W, 1),
        rots (V, 3, 3) w2c, trans (V, 3) w2c.
    """
    dev = scene.centers.device
    rng = np.random.default_rng(seed)
    yaw = rng.uniform(0, 2 * np.pi)
    cy, sy = np.cos(yaw), np.sin(yaw)
    rot_c2w = torch.as_tensor([[cy, 0, -sy], [0, 1, 0], [sy, 0, cy]],
                              dtype=torch.float32, device=dev)
    base = torch.as_tensor(rng.uniform(-1.0, 1.0, size=3),
                           dtype=torch.float32, device=dev)
    z_axis = rot_c2w[:, 2]
    r_w2c = rot_c2w.T
    rgbs, depths, trans = [], [], []
    for off in (np.arange(num_views) - (num_views - 1) / 2.0) * spacing:
        p = base + float(off) * z_axis
        rgb, d = render_panorama(scene, p, rot_c2w, height, width,
                                 convention)
        rgbs.append(rgb)
        depths.append(d)
        trans.append(-r_w2c @ p)
    return {"rgb_panos": torch.stack(rgbs),
            "depth_panos": torch.stack(depths),
            "rots": r_w2c.expand(num_views, 3, 3).contiguous(),
            "trans": torch.stack(trans)}
