"""Ray sampling, projection and compositing for the renderer.

Port of ``panogrf_tpu/renderer/render_ops.py``.  Projections come out
point-major (qn, rn, dn, rfn, c), or depth-major (qn, dn, rn, rfn, c) with
``out["layout"] == "dnr"``.  Query rays are spherical (ERP pixels) or
perspective (``depth2points_perspective``, cube faces).

Stochastic sampling draws from an explicit ``torch.Generator`` on the CPU
(``uniform``, ``normal``), so a run on the card and a run on the CPU with
the same seed sample the same depths.  N processes that each render a
share of one batch's rays draw through a :class:`RayShard` of the same
generator, and together draw what one process draws.
"""

from __future__ import annotations

import torch

from panogrf_tpu_torch.core.sphere import SphereConvention
from panogrf_tpu_torch.ops.resample import interpolate_feats_pointmajor


class RayShard:
    """The draws of share ``index`` of ``count`` equal contiguous shares of
    a batch's rays (axis 1 of every draw): each draw takes the whole
    batch's numbers from the CPU ``generator`` and keeps this share."""

    def __init__(self, generator: torch.Generator, count: int, index: int):
        self.generator, self.count, self.index = generator, count, index


def _draw(sample, generator, shape: tuple, device) -> torch.Tensor:
    """``sample(shape)`` from a CPU ``generator`` (or a :class:`RayShard`
    of one), moved to ``device``."""
    if not isinstance(generator, RayShard):
        return sample(shape, generator=generator).to(device)
    rn, n, i = shape[1], generator.count, generator.index
    full = sample((shape[0], rn * n, *shape[2:]),
                  generator=generator.generator)
    return full[:, i * rn:(i + 1) * rn].to(device)


def uniform(generator: torch.Generator | RayShard, shape: tuple,
            device=None) -> torch.Tensor:
    """U[0, 1) float32 draws of ``shape`` from the CPU ``generator``, moved
    to ``device``: every random number of the sampling comes from here."""
    return _draw(torch.rand, generator, shape, device)


def normal(generator: torch.Generator | RayShard, shape: tuple,
           device=None) -> torch.Tensor:
    """Standard-normal float32 draws of ``shape`` from the CPU
    ``generator``, moved to ``device`` (DINER's Gaussian samples)."""
    return _draw(torch.randn, generator, shape, device)


def sample_depth(qn: int, rn: int, dn: int, near: float, far: float,
                 use_disp: bool, device=None,
                 generator: torch.Generator | None = None) -> tuple:
    """Evenly spaced (in depth or disparity) sample depths; with a
    ``generator``, each inner tick is jittered by (u - 0.5) * 0.999 of an
    interval (stratified training samples).

    :return: (que_depth (qn, rn, dn), que_dists (qn, rn, dn)).
    """
    assert dn > 2
    lo, hi = (1.0 / near, 1.0 / far) if use_disp else (near, far)
    interval = (hi - lo) / (dn - 1)
    val = torch.arange(1, dn - 1, dtype=torch.float32, device=device)
    if generator is not None:
        val = val + (uniform(generator, (qn, rn, dn - 2), device) - 0.5) \
            * 0.999
    else:
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
                      inv_mode: bool = True,
                      generator: torch.Generator | None = None,
                      u: torch.Tensor | None = None) -> torch.Tensor:
    """Hierarchical inverse-CDF sampling at evenly spaced u, at random u
    from ``generator``, or at given (qn, rn, fdn) draws ``u`` (the ft
    renderer hands the same draws to its depth-guided samples).

    The inverse CDF is the JAX package's summation form,
    F^-1(u) = bins[0] + sum_j (bins[j+1]-bins[j]) *
    clip((u-cdf[j]) / (cdf[j+1]-cdf[j]), 0, 1),
    not ``searchsorted``, so the two give the same samples.
    :return: (qn, rn, fdn) fine depths, sorted unless ``generator`` or
        ``u`` is given.
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
    if u is None and generator is None:
        u = (torch.arange(fdn, dtype=torch.float32, device=depth.device)
             + 0.5) / fdn
    elif u is None:
        u = uniform(generator, (*cdf.shape[:-1], fdn), depth.device)
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


def gather_at_coords_batched(grids: torch.Tensor,
                             coords: torch.Tensor) -> torch.Tensor:
    """Index (B, H, W, C) grids at integer coords (B, N, 2) -> (B, N, C)."""
    b = torch.arange(grids.shape[0], device=grids.device)[:, None]
    return grids[b, coords[..., 1].long(), coords[..., 0].long()]


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


def coords2rays_perspective(coords: torch.Tensor, w2c: torch.Tensor,
                            k: torch.Tensor) -> tuple:
    """Pixel coords of perspective cameras -> world rays.

    :param coords: (qn, rn, 2); w2c (qn, 3, 4); k (qn, 3, 3) intrinsics.
    :return: (centers (qn, rn, 3), directions (qn, rn, 3) =
        R^T K^-1 [u, v, 1], unnormalised, so the ray parameter is the
        z-depth).
    """
    rot, trans = w2c[:, :, :3], w2c[:, :, 3]
    centers = -torch.einsum("qji,qj->qi", rot, trans)
    hom = torch.cat([coords, torch.ones_like(coords[..., :1])], -1)
    cam = torch.einsum("qij,qrj->qri", torch.linalg.inv(k), hom)
    dirs = torch.einsum("qji,qrj->qri", rot, cam)
    return centers[:, None].expand(dirs.shape), dirs


def depth2points_perspective(coords: torch.Tensor, que_depth: torch.Tensor,
                             w2c: torch.Tensor, k: torch.Tensor) -> tuple:
    """Perspective twin of ``depth2points_spherical``: points at ray
    parameter ``que_depth`` (qn, rn, dn) along ``coords2rays_perspective``'s
    rays.  :return: (que_pts (qn, rn, dn, 3), que_dir (qn, rn, dn, 3)
    negated unit directions)."""
    centers, dirs = coords2rays_perspective(coords, w2c, k)
    pts = centers[:, :, None] + dirs[:, :, None] * que_depth[..., None]
    que_dir = -dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return pts, que_dir[:, :, None].expand(pts.shape)


def _strided_rows(merged: torch.Tensor, cam: torch.Tensor, shp: tuple,
                  ax: int, s: int, convention: SphereConvention, h: int,
                  w: int, nearest: bool) -> torch.Tensor:
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
    g = interpolate_feats_pointmajor(merged, xy_sub_vm, h, w,
                                     nearest=nearest)
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
                        depth_major: bool = False,
                        gather_stride: int = 1,
                        gather_nearest: bool = False) -> dict:
    """Project query points into every reference ERP view and gather.

    With ``merged_full`` in ``ref_data`` (fast gather) each (sample, view)
    fetches one row of the full-res [rgb | ray feats | img feats | stats]
    map (its 2x2 window, or its nearest pixel with ``gather_nearest``),
    at every ``gather_stride``-th sample only when the stride is > 1;
    otherwise rgb comes from ``imgs`` and the features from the 1/4-res
    ``merged_feats``, or, without that map (the ft renderer), from
    ``ray_feats`` and ``img_feats``, each at its own resolution.
    ``que_dir`` gives the fused ``dir_diff`` feature.

    :param que_pts: (qn, rn, dn, 3) world points; que_dir likewise.
    :return: dict of (qn, rn, dn, rfn, c) tensors — (qn, dn, rn, rfn, c)
        with ``layout == "dnr"`` when ``depth_major``.
    """
    qn, rn, dn, _ = que_pts.shape
    rfn, h, w, _ = ref_data["imgs"].shape
    if depth_major:
        que_pts = que_pts.transpose(1, 2)
        que_dir = que_dir.transpose(1, 2)
    pts = que_pts.reshape(-1, 3)

    w2c = ref_data["w2c"]
    cam = torch.einsum("vij,pj->pvi", w2c[:, :, :3], pts) + w2c[None, :, :, 3]
    stride_geom = "merged_full" in ref_data and gather_stride > 1
    if stride_geom:
        # only every s-th sample's pixel coords are consumed; the distance
        # is the camera-frame norm for all samples
        prj_depth = torch.linalg.norm(cam, dim=-1)
    else:
        prj_xy, prj_depth = convention.project_to_pixels(cam, h, w)
        xy_vm = prj_xy.transpose(0, 1)

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
    stats = None
    if "merged_full" in ref_data:
        if stride_geom:
            shp = (qn, dn, rn) if depth_major else (qn, rn, dn)
            allf = _strided_rows(ref_data["merged_full"], cam, shp,
                                 1 if depth_major else 2, gather_stride,
                                 convention, h, w, gather_nearest)
        else:
            allf = interpolate_feats_pointmajor(ref_data["merged_full"],
                                                xy_vm, h, w,
                                                nearest=gather_nearest)
        prj_rgb = allf[..., :3]
        prj_ray_feats = allf[..., 3:3 + nd]
        prj_img_feats = allf[..., 3 + nd:3 + nd + ni]
        if allf.shape[-1] > 3 + nd + ni:
            stats = allf[..., 3 + nd + ni:]
    elif "merged_feats" in ref_data:
        prj_rgb = interpolate_feats_pointmajor(ref_data["imgs"], xy_vm, h, w)
        # the map is float32 where the ray features were resized onto the
        # image features' grid (``resize_linear`` promotes); its rows take
        # the pass's compute dtype, as the merged_full rows do
        merged = interpolate_feats_pointmajor(ref_data["merged_feats"],
                                              xy_vm, h, w).to(cdt)
        prj_ray_feats = merged[..., :nd]
        prj_img_feats = merged[..., nd:]
    else:
        prj_rgb = interpolate_feats_pointmajor(ref_data["imgs"], xy_vm, h, w)
        prj_ray_feats = interpolate_feats_pointmajor(ref_data["ray_feats"],
                                                     xy_vm, h, w)
        prj_img_feats = interpolate_feats_pointmajor(ref_data["img_feats"],
                                                     xy_vm, h, w)

    shape = (qn, dn, rn, rfn, -1) if depth_major else (qn, rn, dn, rfn, -1)
    out = {
        "depth": prj_depth[..., None].reshape(shape),
        "ray_feats": prj_ray_feats.reshape(shape),
        "rgb": prj_rgb.reshape(shape),
        "img_feats": prj_img_feats.reshape(shape),
        "dir_diff": prj_dir_diff.reshape(shape),
    }
    if stats is not None:
        out["stats"] = stats.reshape(shape)
    if depth_major:
        out["layout"] = "dnr"
    return out


def project_stats(ref_data: dict, que_pts: torch.Tensor,
                  convention: SphereConvention) -> dict:
    """The light coarse pass's projection: each point's distance from every
    reference camera and one bilinear fetch of the per-scene decoded
    mixture statistics ``ref_data["stats_coarse"]`` (rfn, H, W, 5 or 6).

    :param que_pts: (qn, rn, dn, 3).
    :return: ``depth`` (qn, rn, dn, rfn, 1), ``stats`` (qn, rn, dn, rfn, s).
    """
    qn, rn, dn, _ = que_pts.shape
    rfn, h, w, _ = ref_data["imgs"].shape
    w2c = ref_data["w2c"]
    cam = torch.einsum("vij,pj->pvi", w2c[:, :, :3],
                       que_pts.reshape(-1, 3)) + w2c[None, :, :, 3]
    prj_xy, prj_depth = convention.project_to_pixels(cam, h, w)
    stats = interpolate_feats_pointmajor(ref_data["stats_coarse"],
                                         prj_xy.transpose(0, 1), h, w)
    shape = (qn, rn, dn, rfn, -1)
    return {"depth": prj_depth[..., None].reshape(shape),
            "stats": stats.reshape(shape)}


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


def merge_composites(depth_a: torch.Tensor, colors_a: torch.Tensor,
                     density_a: torch.Tensor, depth_b: torch.Tensor,
                     colors_b: torch.Tensor, density_b: torch.Tensor) -> tuple:
    """Composite the union of two passes' samples along each ray: the
    (depth, colour, density) triples of both, sorted by depth (a stable
    sort, as JAX's, so equal depths keep pass a's sample first) and
    alpha-composited as one ray.  Both passes must have run the same
    decoder and aggregation net, so their densities compare.

    :param depth_*: (qn, rn, dn_*); colors_* (qn, rn, dn_*, 3).
    :return: (que_depth, colors, density, ``density2outputs`` dict) of the
        sorted union.
    """
    z = torch.cat([depth_a, depth_b], -1)
    colors = torch.cat([colors_a, colors_b], -2)
    density = torch.cat([density_a, density_b], -1)
    z, order = torch.sort(z, dim=-1, stable=True)
    density = torch.gather(density, -1, order)
    colors = torch.gather(colors, -2, order[..., None].expand(colors.shape))
    return z, colors, density, density2outputs(density, colors, z)
