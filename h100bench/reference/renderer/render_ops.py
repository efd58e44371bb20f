"""Ray sampling, projection and compositing for the renderer.

Frozen from the port's ``renderer/render_ops.py``, cut to the serving
path: deterministic samples, spherical query rays, depth-major
projections (qn, dn, rn, rfn, c) fetched from the full-res merged map.
"""

from __future__ import annotations

import torch

from h100bench.reference.core.sphere import SphereConvention
from h100bench.reference.ops.resample import interpolate_feats_pointmajor


def sample_depth(qn: int, rn: int, dn: int, near: float, far: float,
                 use_disp: bool, device=None) -> tuple:
    """Evenly spaced (in depth or disparity) sample depths.

    :return: (que_depth (qn, rn, dn), que_dists (qn, rn, dn)).
    """
    assert dn > 2
    lo, hi = (1.0 / near, 1.0 / far) if use_disp else (near, far)
    interval = (hi - lo) / (dn - 1)
    val = torch.arange(1, dn - 1, dtype=torch.float32, device=device)
    val = val.expand(qn, rn, dn - 2)
    ticks = torch.cat([torch.zeros(qn, rn, 1, device=device), interval * val,
                       torch.full((qn, rn, 1), hi - lo, device=device)], -1)
    depth = 1.0 / (1.0 / near + ticks) if use_disp else near + ticks
    dists = torch.cat([depth[..., 1:],
                       torch.full((qn, rn, 1), 1e6, device=device)],
                      -1) - depth
    return depth, dists


def depth2inv_dists(depth: torch.Tensor,
                    depth_range: torch.Tensor) -> torch.Tensor:
    """Sample intervals in normalized inverse-depth space."""
    near = -1.0 / depth_range[:, 0][:, None, None]
    far = -1.0 / depth_range[:, 1][:, None, None]
    d = (-1.0 / depth - near) / (far - near)
    return torch.cat([d[..., 1:] - d[..., :-1],
                      torch.full((*d.shape[:-1], 1), 1e6, dtype=d.dtype,
                                 device=d.device)], -1)


def sample_fine_depth(depth: torch.Tensor, hit_prob: torch.Tensor,
                      depth_range: torch.Tensor, fdn: int,
                      inv_mode: bool = True) -> torch.Tensor:
    """Hierarchical inverse-CDF sampling at evenly spaced u.

    The inverse CDF is the JAX package's summation form,
    F^-1(u) = bins[0] + sum_j (bins[j+1]-bins[j]) *
    clip((u-cdf[j]) / (cdf[j+1]-cdf[j]), 0, 1),
    not ``searchsorted``, so the two give the same samples.
    :return: (qn, rn, fdn) fine depths, sorted.
    """
    if inv_mode:
        near = -1.0 / depth_range[0, 0]
        far = -1.0 / depth_range[0, 1]
        depth = (-1.0 / depth - near) / (far - near)
    center = (depth[..., 1:] + depth[..., :-1]) / 2.0
    bins = torch.cat([depth[..., :1], center, depth[..., -1:]], -1)
    pdf = hit_prob + 1e-5
    pdf = pdf / torch.sum(pdf, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    u = (torch.arange(fdn, dtype=torch.float32, device=depth.device)
         + 0.5) / fdn
    bin_w = bins[..., 1:] - bins[..., :-1]
    cdf0 = cdf[..., :-1]
    dcdf = torch.clamp(cdf[..., 1:] - cdf[..., :-1], min=1e-10)
    t = (u[..., :, None] - cdf0[..., None, :]) / dcdf[..., None, :]
    fine = bins[..., :1] + torch.sum(bin_w[..., None, :]
                                     * torch.clamp(t, 0.0, 1.0), -1)
    if inv_mode:
        fine = -1.0 / (fine * (far - near) + near)
    return fine


def gather_at_coords(grid: torch.Tensor,
                     coords: torch.Tensor) -> torch.Tensor:
    """Index an (H, W, C) grid at integer pixel coords (..., 2)."""
    return grid[coords[..., 1].long(), coords[..., 0].long()]


def depth2points_spherical(coords: torch.Tensor, que_depth: torch.Tensor,
                           c2w: torch.Tensor,
                           directions: torch.Tensor) -> tuple:
    """Sample points along spherical rays.

    :param coords: (qn, rn, 2); que_depth (qn, rn, dn); c2w (3, 4), one
        pose for every query, or (qn, 3, 4), a pose per query (the video
        path's frame batch); directions (H, W, 3) unit camera-frame rays.
    :return: (que_pts (qn, rn, dn, 3) world, que_dir (qn, rn, dn, 3)
        negated unit ray directions).
    """
    dirs_cam = gather_at_coords(directions, coords)
    if c2w.dim() == 2:
        dirs_w = torch.einsum("ij,qrj->qri", c2w[:3, :3], dirs_cam)
        origin = c2w[:3, 3]
    else:
        dirs_w = torch.einsum("qij,qrj->qri", c2w[:, :3, :3], dirs_cam)
        origin = c2w[:, None, None, :3, 3]
    pts = origin + dirs_w[:, :, None] * que_depth[..., None]
    que_dir = -dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    return pts, que_dir[:, :, None].expand(pts.shape)


def _strided_rows(merged: torch.Tensor, cam: torch.Tensor, shp: tuple,
                  ax: int, s: int, convention: SphereConvention, h: int,
                  w: int) -> torch.Tensor:
    """Fetch merged-map rows at every ``s``-th sample along axis ``ax`` of
    the (qn, a, b) point grid and lerp the rows in between; the trailing
    partial group extrapolates from its left row.  :return: (pn, rfn, c).
    """
    rfn = cam.shape[1]
    dn = shp[ax]
    kk = -(-dn // s)
    cam5 = cam.reshape(*shp, rfn, 3)
    idx = [slice(None)] * 5
    idx[ax] = slice(0, dn, s)
    xy_sub, _ = convention.project_to_pixels(cam5[tuple(idx)], h, w)
    xy_sub_vm = xy_sub.reshape(-1, rfn, 2).transpose(0, 1)
    g = interpolate_feats_pointmajor(merged, xy_sub_vm, h, w)
    c = g.shape[-1]
    gshp = list(shp)
    gshp[ax] = kk
    g = g.reshape(*gshp, rfn, c)
    g_r = torch.cat([g.narrow(ax, 1, kk - 1), g.narrow(ax, kk - 1, 1)], ax)
    wshape = [1] * 6
    wshape[ax + 1] = s
    wts = (torch.arange(s, dtype=torch.float32, device=g.device) / s) \
        .reshape(wshape).to(g.dtype)
    full = g.unsqueeze(ax + 1) * (1 - wts) + g_r.unsqueeze(ax + 1) * wts
    fshp = list(gshp)
    fshp[ax] = kk * s
    full = full.reshape(*fshp, rfn, c).narrow(ax, 0, dn)
    return full.reshape(-1, rfn, c)


def project_points_dict(ref_data: dict, que_pts: torch.Tensor,
                        convention: SphereConvention,
                        que_dir: torch.Tensor,
                        gather_stride: int = 1) -> dict:
    """Project query points into every reference ERP view and gather.

    Each (sample, view) fetches one row (its 2x2 window) of the full-res
    [rgb | ray feats | img feats | stats] map ``merged_full``, at every
    ``gather_stride``-th sample only when the stride is > 1.  ``que_dir``
    gives the fused ``dir_diff`` feature.

    :param que_pts: (qn, rn, dn, 3) world points; que_dir likewise.
    :return: dict of depth-major (qn, dn, rn, rfn, c) tensors.
    """
    qn, rn, dn, _ = que_pts.shape
    rfn, h, w, _ = ref_data["imgs"].shape
    que_pts = que_pts.transpose(1, 2)
    que_dir = que_dir.transpose(1, 2)
    pts = que_pts.reshape(-1, 3)

    w2c = ref_data["w2c"]
    cam = torch.einsum("vij,pj->pvi", w2c[:, :, :3], pts) + w2c[None, :, :, 3]
    if gather_stride > 1:
        # only every s-th sample's pixel coords are consumed; the distance
        # is the camera-frame norm for all samples
        prj_depth = torch.linalg.norm(cam, dim=-1)
    else:
        prj_xy, prj_depth = convention.project_to_pixels(cam, h, w)

    cam_pos = -torch.einsum("vji,vj->vi", w2c[:, :, :3], w2c[:, :, 3])
    d = pts[:, None] - cam_pos[None]
    prj_dir = -d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                               min=1e-5)
    cdt = que_dir.dtype
    qd = que_dir.reshape(-1, 1, 3).to(cdt)
    pd = prj_dir.to(cdt)
    dot = torch.sum(pd * qd, -1, keepdim=True)
    prj_dir_diff = torch.cat([pd - qd, dot], -1)

    nd = ref_data["ray_feats"].shape[-1]
    ni = ref_data["img_feats"].shape[-1]
    if gather_stride > 1:
        allf = _strided_rows(ref_data["merged_full"], cam, (qn, dn, rn), 1,
                             gather_stride, convention, h, w)
    else:
        allf = interpolate_feats_pointmajor(ref_data["merged_full"],
                                            prj_xy.transpose(0, 1), h, w)
    shape = (qn, dn, rn, rfn, -1)
    return {"depth": prj_depth[..., None].reshape(shape),
            "ray_feats": allf[..., 3:3 + nd].reshape(shape),
            "rgb": allf[..., :3].reshape(shape),
            "img_feats": allf[..., 3 + nd:3 + nd + ni].reshape(shape),
            "dir_diff": prj_dir_diff.reshape(shape),
            "stats": allf[..., 3 + nd + ni:].reshape(shape),
            "layout": "dnr"}


def alpha_values2hit_prob(alpha: torch.Tensor) -> torch.Tensor:
    """alpha (qn, rn, dn) -> hit prob via the transmittance cumprod."""
    no_hit = torch.cat([torch.ones_like(alpha[..., :1]),
                        1.0 - alpha + 1e-10], -1)
    return alpha * torch.cumprod(no_hit, -1)[..., :-1]


def density2outputs(density: torch.Tensor, colors: torch.Tensor,
                    que_depth: torch.Tensor) -> dict:
    """density (qn, rn, dn), colors (qn, rn, dn, 3) -> composited outputs."""
    alpha = 1.0 - torch.exp(-torch.relu(density))
    hit_prob = alpha_values2hit_prob(alpha)
    return {"hit_prob": hit_prob,
            "pixel_colors": torch.sum(hit_prob[..., None] * colors, 2),
            "render_depth": torch.sum(hit_prob * que_depth, -1)}
