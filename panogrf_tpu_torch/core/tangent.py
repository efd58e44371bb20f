"""ERP <-> gnomonic tangent-patch resampling as precomputed gather grids.

Port of ``panogrf_tpu/core/tangent.py``.  The ERP sphere is covered by N
gnomonic patches (``nrows`` 3/4/5/6 -> 10/18/26/46 patches);
``equi_to_tangent`` resamples each ERP image onto every patch and
``tangent_to_equi`` paints each ERP pixel from its one owning patch.  The
grids are static functions of the geometry: own copies of the JAX
package's numpy grid functions (float64, then float32), computed in the
same order so that both packages sample at the same coordinates and give
every boundary pixel the same owner; each is moved to the device once per
shape.
The resampling is the 4-tap gather of :mod:`panogrf_tpu_torch.ops.resample`.

The tangent frame is the reference's: lon in [-pi, pi] maps linearly to
ERP x and lat in [-pi/2, pi/2] to ERP y (row 0 = lat -90 deg), both scaled
by (W - 1) and (H - 1) (align-corners), not the sphere convention's
pixel-centre rule.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from panogrf_tpu_torch.ops.resample import batched_bilinear_sample

PATCH_LAYOUTS = {
    3: ([3, 4, 3], [-60.0, 0.0, 60.0]),
    4: ([3, 6, 6, 3], [-67.5, -22.5, 22.5, 67.5]),
    5: ([3, 6, 8, 6, 3], [-72.2, -36.1, 0.0, 36.1, 72.2]),
    6: ([3, 8, 12, 12, 8, 3],
        [-75.2, -45.93, -15.72, 15.72, 45.93, 75.2]),
}

NPATCHES = {3: 10, 4: 18, 5: 26, 6: 46}


def patch_centers(nrows: int) -> np.ndarray:
    """(N, 2) array of (theta_deg in [0, 360), phi_deg in [-90, 90])."""
    num_cols, phi_centers = PATCH_LAYOUTS[nrows]
    centers = []
    for i, n_cols in enumerate(num_cols):
        ti = 360.0 / n_cols
        for j in range(n_cols):
            centers.append([j * ti + ti / 2.0, phi_centers[i]])
    return np.asarray(centers, np.float64)


@functools.lru_cache(maxsize=16)
def _e2p_grid(erp_h: int, erp_w: int, nrows: int, ph: int, pw: int,
              fov_h: float, fov_w: float) -> np.ndarray:
    """ERP pixel coords (N, ph, pw, 2) of each patch pixel (align-corners):
    the inverse gnomonic projection."""
    centers = patch_centers(nrows)
    lon_c = (centers[:, 0] / 360.0 * 2.0 - 1.0) * np.pi      # [-pi, pi)
    lat_c = centers[:, 1] / 180.0 * np.pi                     # [-pi/2,pi/2]

    yy, xx = np.meshgrid(np.linspace(0, 1, ph), np.linspace(0, 1, pw),
                         indexing="ij")
    x = (xx * 2 - 1) * np.pi * (fov_w / 360.0)
    y = (yy * 2 - 1) * (np.pi / 2) * (fov_h / 180.0)
    rou = np.sqrt(x ** 2 + y ** 2)
    rou = np.where(rou == 0, 1e-12, rou)
    c = np.arctan(rou)
    sin_c, cos_c = np.sin(c), np.cos(c)

    lat = np.arcsin(cos_c[None] * np.sin(lat_c)[:, None, None]
                    + (y[None] * sin_c[None]
                       * np.cos(lat_c)[:, None, None]) / rou[None])
    lon = lon_c[:, None, None] + np.arctan2(
        x[None] * sin_c[None],
        rou[None] * np.cos(lat_c)[:, None, None] * cos_c[None]
        - y[None] * np.sin(lat_c)[:, None, None] * sin_c[None])
    lon = (lon + np.pi) % (2 * np.pi) - np.pi
    px = (lon / np.pi + 1.0) * 0.5 * (erp_w - 1)
    py = (lat / (np.pi / 2) + 1.0) * 0.5 * (erp_h - 1)
    return np.stack([px, py], -1).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _p2e_grid(erp_h: int, erp_w: int, nrows: int, ph: int, pw: int,
              fov_h: float, fov_w: float):
    """(owning patch index (H, W) int32, in-patch pixel coords (H, W, 2)):
    ownership rectangles by a floor of degrees, then the forward gnomonic
    projection."""
    num_cols, phi_centers = PATCH_LAYOUTS[nrows]
    phi_interval = 180 // len(num_cols)
    ys, xs = np.meshgrid(np.arange(erp_h), np.arange(erp_w), indexing="ij")
    lat = (2.0 * ys / (erp_h - 1) - 1.0) * (np.pi / 2)
    lon = (2.0 * xs / (erp_w - 1) - 1.0) * np.pi

    lat_deg = lat * 180 / np.pi
    row = np.clip(((lat_deg + 90) // phi_interval).astype(int), 0,
                  len(num_cols) - 1)
    # the centres' theta in [0, 360) has lon_c = (theta/360*2 - 1)*pi, so
    # theta(lon) = (lon/pi + 1) * 180
    theta_deg = ((lon / np.pi + 1.0) * 180.0) % 360
    idx = np.zeros((erp_h, erp_w), np.int32)
    row_offset = np.cumsum([0] + num_cols[:-1])
    for i, n_cols in enumerate(num_cols):
        m = row == i
        col = np.clip((theta_deg[m] / (360.0 / n_cols)).astype(int), 0,
                      n_cols - 1)
        idx[m] = row_offset[i] + col

    centers = patch_centers(nrows)
    lon_c = (centers[:, 0] / 360.0 * 2.0 - 1.0) * np.pi
    lat_c = centers[:, 1] / 180.0 * np.pi
    lc, pc = lon_c[idx], lat_c[idx]
    dlon = (lon - lc + np.pi) % (2 * np.pi) - np.pi
    cos_c = np.sin(pc) * np.sin(lat) + np.cos(pc) * np.cos(lat) * np.cos(dlon)
    cos_c = np.maximum(cos_c, 1e-6)
    gx = np.cos(lat) * np.sin(dlon) / cos_c
    gy = (np.cos(pc) * np.sin(lat)
          - np.sin(pc) * np.cos(lat) * np.cos(dlon)) / cos_c
    u = (gx / (np.pi * fov_w / 360.0) + 1.0) * 0.5 * (pw - 1)
    v = (gy / ((np.pi / 2) * fov_h / 180.0) + 1.0) * 0.5 * (ph - 1)
    return idx, np.stack([u, v], -1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _grid(kind: str, shape: tuple, device: torch.device) -> torch.Tensor:
    """The sampling grid on ``device``, built once per shape and device.
    ``p2e`` is the grid into one tall image of the N patches stacked along
    H: in-patch coords clamped into the patch (so the lower tap at
    v = ph - 1 is the next patch's row with weight 0), y offset by the
    owner's index times ph, in float32 as in the JAX package."""
    if kind == "e2p":
        return torch.from_numpy(_e2p_grid(*shape)).to(device)
    ph, pw = shape[3], shape[4]
    idx, xy = (torch.from_numpy(a) for a in _p2e_grid(*shape))
    u = torch.clamp(xy[..., 0], 0.0, pw - 1.0)
    v = torch.clamp(xy[..., 1], 0.0, ph - 1.0) + idx.float() * ph
    return torch.stack([u, v], -1).to(device)


def equi_to_tangent(erp: torch.Tensor, nrows: int = 4, patch_size=(128, 128),
                    fov=(80.0, 80.0)) -> torch.Tensor:
    """ERP images (B, H, W, C) -> patches (B, N, ph, pw, C): bilinear,
    longitude-wrapping."""
    b, h, w, _ = erp.shape
    ph, pw = patch_size
    grid = _grid("e2p", (h, w, nrows, ph, pw, float(fov[0]), float(fov[1])),
                 erp.device)
    return batched_bilinear_sample(erp, grid.expand(b, *grid.shape))


def tangent_to_equi(patches: torch.Tensor, erp_hw, nrows: int = 4,
                    fov=(80.0, 80.0)) -> torch.Tensor:
    """Patches (B, N, ph, pw, C) -> ERP (B, H, W, C), each pixel bilinear
    within its one owning patch (border clamp)."""
    b, n, ph, pw, c = patches.shape
    h, w = erp_hw
    grid = _grid("p2e", (h, w, nrows, ph, pw, float(fov[0]), float(fov[1])),
                 patches.device)
    return batched_bilinear_sample(patches.reshape(b, n * ph, pw, c),
                                   grid.expand(b, *grid.shape), wrap_x=False)
