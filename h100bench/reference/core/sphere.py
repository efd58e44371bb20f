"""Spherical geometry for equirectangular (ERP) panoramas.

Frozen from the port's ``core/sphere.py``, with the ``m3d`` convention
(the one the renderer and the depth stack use).  ``corner`` pixel mode maps pixel x in [0, W-1] onto
the full longitude range (the renderer's grid);
``center`` mode puts pixel x at fraction (x + 0.5) / W (the cost volume's
pixel-centre grid).  Coordinates live in the trailing axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch

_TWO_PI = 2.0 * math.pi
_PI = math.pi
# Guards keeping gradients finite at the poles; 1 - 1e-8 rounds back to
# 1.0f, hence the larger trig clip.
_EPS = 1e-8
_EPS_TRIG = 1e-6


def _safe_acos(x: torch.Tensor) -> torch.Tensor:
    return torch.acos(torch.clamp(x, -1.0 + _EPS_TRIG, 1.0 - _EPS_TRIG))


def _safe_atan2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """atan2 evaluated at a point nudged off the (0, 0) pole."""
    degenerate = (a.abs() < _EPS) & (b.abs() < _EPS)
    b_safe = torch.where(degenerate, torch.full_like(b, _EPS), b)
    return torch.atan2(torch.where(degenerate, torch.zeros_like(a), a),
                       b_safe)


@dataclasses.dataclass(frozen=True)
class SphereConvention:
    """An ERP coordinate convention; spherical tuples are (theta, phi, r)."""

    name: str
    _pix_to_sph: Callable
    _sph_to_cart: Callable
    _cart_to_sph: Callable
    _sph_to_pix: Callable

    def equi_to_spherical(self, xy: torch.Tensor, height: int, width: int,
                          radius: float = 1.0,
                          mode: str = "corner") -> torch.Tensor:
        """Pixel coords (..., 2) -> spherical (..., 3)."""
        if mode == "corner":
            fx = torch.clamp(xy[..., 0], 0.0, width - 1.0) / (width - 1.0)
            fy = torch.clamp(xy[..., 1], 0.0, height - 1.0) / (height - 1.0)
        elif mode == "center":
            fx = (xy[..., 0] + 0.5) / width
            fy = (xy[..., 1] + 0.5) / height
        else:
            raise ValueError(f"unknown pixel mode {mode!r}")
        theta, phi = self._pix_to_sph(fx, fy)
        return torch.stack([theta, phi, torch.full_like(theta, radius)], -1)

    def spherical_to_cartesian(self, sph: torch.Tensor) -> torch.Tensor:
        theta, phi = sph[..., 0], sph[..., 1]
        r = sph[..., 2] if sph.shape[-1] == 3 else torch.ones_like(theta)
        return torch.stack(self._sph_to_cart(theta, phi, r), -1)

    def cartesian_to_spherical(self, pts: torch.Tensor) -> torch.Tensor:
        r = torch.linalg.norm(pts, dim=-1)
        theta, phi = self._cart_to_sph(pts[..., 0], pts[..., 1],
                                       pts[..., 2], torch.clamp(r, min=_EPS))
        return torch.stack([theta, phi, r], -1)

    def spherical_to_equi(self, sph: torch.Tensor, height: int,
                          width: int, mode: str = "corner") -> torch.Tensor:
        fx, fy = self._sph_to_pix(sph[..., 0], sph[..., 1])
        if mode == "corner":
            return torch.stack([fx * (width - 1.0), fy * (height - 1.0)], -1)
        if mode == "center":
            return torch.stack([fx * width - 0.5, fy * height - 0.5], -1)
        raise ValueError(f"unknown pixel mode {mode!r}")

    def pixel_grid(self, height: int, width: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
        """(H, W, 2) grid of (x, y) pixel coordinates (float32)."""
        x = torch.arange(width, dtype=torch.float32, device=device)
        y = torch.arange(height, dtype=torch.float32, device=device)
        yy, xx = torch.meshgrid(y, x, indexing="ij")
        return torch.stack([xx, yy], -1)

    def ray_directions(self, height: int, width: int,
                       device: torch.device | str = "cpu",
                       mode: str = "corner") -> torch.Tensor:
        """Unit ray directions per ERP pixel, (H, W, 3)."""
        sph = self.equi_to_spherical(self.pixel_grid(height, width, device),
                                     height, width, mode=mode)
        dirs = self.spherical_to_cartesian(sph)
        return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)

    def project_to_pixels(self, pts_cam: torch.Tensor, height: int,
                          width: int, mode: str = "corner") -> tuple:
        """Camera-frame points (..., 3) -> (pixel xy (..., 2), distance)."""
        sph = self.cartesian_to_spherical(pts_cam)
        return (self.spherical_to_equi(sph, height, width, mode),
                sph[..., 2])


def _m3d_pix_to_sph(fx, fy):
    return fx * _TWO_PI - 0.5 * _PI, fy * _PI


def _m3d_sph_to_cart(theta, phi, r):
    sp = torch.sin(phi)
    return r * sp * torch.cos(theta), r * torch.cos(phi), \
        r * sp * torch.sin(theta)


def _m3d_cart_to_sph(x, y, z, r):
    return _safe_atan2(z, x), _safe_acos(y / r)


def _m3d_sph_to_pix(theta, phi):
    return torch.remainder(theta + 0.5 * _PI, _TWO_PI) / _TWO_PI, phi / _PI


M3D = SphereConvention("m3d", _m3d_pix_to_sph, _m3d_sph_to_cart,
                       _m3d_cart_to_sph, _m3d_sph_to_pix)
CONVENTIONS: Dict[str, SphereConvention] = {"m3d": M3D}


def get_convention(name: str) -> SphereConvention:
    try:
        return CONVENTIONS[name]
    except KeyError:
        raise KeyError(f"unknown sphere convention {name!r}; available: "
                       f"{sorted(CONVENTIONS)}") from None
