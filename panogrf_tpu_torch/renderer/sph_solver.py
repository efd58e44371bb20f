"""Spherical-harmonics least-squares solver and depth -> normal.

Port of ``panogrf_tpu/renderer/sph_solver.py``:

* :class:`SphericalHarmonicsSolver` — regularised weighted least-squares fit
  of SH colour coefficients per point, and their prediction;
* :func:`depth2normal` — central-difference normals of an ERP point cloud,
  for DINER's backface culling.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from panogrf_tpu_torch.core.sphere import SphereConvention


def _sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    parts = [torch.ones_like(x)[..., None]]
    if degree >= 1:
        parts.append(torch.stack([x, y, z], -1))
    if degree >= 2:
        parts.append(torch.stack(
            [x * y, y * z, -x**2 - y**2 + 2 * z**2, z * x, x**2 - y**2], -1))
    if degree >= 3:
        parts.append(torch.stack([
            (3 * x**2 - y**2) * y, x * y * z, y * (4 * z**2 - x**2 - y**2),
            z * (2 * z**2 - 3 * x**2 - 3 * y**2),
            x * (4 * z**2 - x**2 - y**2), (x**2 - y**2) * z,
            (x**2 - 3 * y**2) * x], -1))
    if degree >= 4:
        parts.append(torch.stack([
            x * y * (x**2 - y**2), (3 * x**2 - y**2) * y * z,
            x * y * (7 * z**2 - 1), y * z * (7 * z**2 - 3),
            35 * z**4 - 30 * z**2 + 3, x * z * (7 * z**2 - 3),
            (x**2 - y**2) * (7 * z**2 - 1), (x**2 - 3 * y**2) * x * z,
            x**2 * (x**2 - 3 * y**2) - y**2 * (3 * x**2 - y**2)], -1))
    return torch.cat(parts, -1)


@dataclasses.dataclass(frozen=True)
class SphericalHarmonicsSolver:
    degree: int = 3
    init_regs: tuple = (0.001, 0.005, 0.05, 0.1)

    def _regs(self, like: torch.Tensor) -> torch.Tensor:
        regs = [np.zeros(1)]
        for l in range(1, self.degree + 1):
            regs.append(np.ones(2 * l + 1) * self.init_regs[l - 1])
        return torch.as_tensor(np.concatenate(regs), dtype=like.dtype,
                               device=like.device)

    def fit(self, directions: torch.Tensor, colors: torch.Tensor,
            weights: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
        """Weighted regularised fit: directions (b, n, 3), colors
        (b, n, 3), weights (b, n) -> coefficients (b, k, 3)."""
        a = _sh_basis(directions, self.degree)
        insufficient = torch.sum(weights, 1, keepdim=True) < eps
        weights = weights + insufficient.to(weights.dtype) * eps
        aw = (a * weights[..., None]).transpose(-1, -2)
        mat = aw @ a + torch.diag(self._regs(a))[None]
        return torch.linalg.solve(mat, aw @ colors)

    __call__ = fit

    def predict(self, directions: torch.Tensor,
                theta: torch.Tensor) -> torch.Tensor:
        return _sh_basis(directions, self.degree) @ theta


def depth2normal(mvs_depth: torch.Tensor,
                 convention: SphereConvention) -> torch.Tensor:
    """Central-difference normals of ERP distance maps (the map wraps in
    longitude and is zero-padded at the poles).

    :param mvs_depth: (N, H, W, 1) radial distance.
    :return: (N, H, W, 3) unit normals in the camera frame, 0 where the
        depth is 0.
    """
    _, h, w, _ = mvs_depth.shape
    rays = convention.ray_directions(h, w, mvs_depth.device) \
        .to(mvs_depth.dtype)
    p = rays[None] * mvs_depth
    p = torch.nn.functional.pad(p, (0, 0, 0, 0, 1, 1))
    p = torch.cat([p[:, :, -1:], p, p[:, :, :1]], 2)
    down, up = p[:, 2:, 1:-1], p[:, :-2, 1:-1]
    right, left = p[:, 1:-1, 2:], p[:, 1:-1, :-2]
    normal = torch.linalg.cross(down - up, right - left, dim=-1)
    normal = normal / torch.clamp(
        torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-8)
    return torch.where(mvs_depth == 0, torch.zeros_like(normal), normal)
