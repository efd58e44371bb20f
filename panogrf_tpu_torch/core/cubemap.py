"""ERP <-> cubemap resampling as precomputed gather grids.

Port of ``panogrf_tpu/core/cubemap.py``.  The sampling grids are static
functions of (H, W, face_w), computed once with numpy (own copies of the
JAX package's ``_e2c_grid``/``_c2e_grid``, float64 then float32, so both
packages sample at the same coordinates); the resampling itself is the
4-tap bilinear gather of :mod:`panogrf_tpu_torch.ops.resample`.  Face
order is [F R B L U D].

Layouts: cube tensors are (B, 6, fw, fw, C) ("stacked"), with helpers to
convert to the reference's horizontal strip (fw, 6*fw, C).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from panogrf_tpu_torch.ops.resample import batched_bilinear_sample


@functools.lru_cache(maxsize=32)
def _e2c_grid(equ_h: int, equ_w: int, face_w: int) -> np.ndarray:
    """ERP pixel coords (6, fw, fw, 2) for each cube-face pixel."""
    rng = np.linspace(-0.5, 0.5, num=face_w, dtype=np.float64)
    gx, gy = np.meshgrid(rng, -rng)

    xyz = np.zeros((6, face_w, face_w, 3), np.float64)
    xyz[0, ..., 0], xyz[0, ..., 1], xyz[0, ..., 2] = gx, gy, 0.5          # F
    xyz[1, ..., 2], xyz[1, ..., 1], xyz[1, ..., 0] = -gx, gy, 0.5         # R
    xyz[2, ..., 0], xyz[2, ..., 1], xyz[2, ..., 2] = -gx, gy, -0.5        # B
    xyz[3, ..., 2], xyz[3, ..., 1], xyz[3, ..., 0] = gx, gy, -0.5         # L
    xyz[4, ..., 0], xyz[4, ..., 2], xyz[4, ..., 1] = \
        np.flipud(gx), np.flipud(gy), 0.5                                 # U
    xyz[5, ..., 0], xyz[5, ..., 2], xyz[5, ..., 1] = gx, gy, -0.5         # D

    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(x, z)
    lat = np.arctan2(y, np.sqrt(x * x + z * z))
    coor_x = (lon / (2 * np.pi) + 0.5) * equ_w - 0.5
    coor_y = (-lat / np.pi + 0.5) * equ_h - 0.5
    return np.stack([coor_x, coor_y], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _c2e_grid(face_w: int, equ_h: int, equ_w: int) -> tuple:
    """(face index (H, W) int32, face pixel coords (H, W, 2)) per ERP
    pixel: nearest-face assignment and gnomonic uv (py360convert)."""
    if equ_w % 4 != 0:
        raise ValueError(
            f"cube_to_equi requires ERP width divisible by 4, got {equ_w}")
    tp = np.roll(np.arange(4).repeat(equ_w // 4)[None, :].repeat(equ_h, 0),
                 3 * equ_w // 8, 1)
    mask = np.zeros((equ_h, equ_w // 4), bool)
    idx = np.linspace(-np.pi, np.pi, equ_w // 4) / 4
    idx = equ_h // 2 - np.round(np.arctan(np.cos(idx)) * equ_h / np.pi) \
        .astype(int)
    for i, j in enumerate(idx):
        mask[:j, i] = 1
    mask = np.roll(np.concatenate([mask] * 4, 1), 3 * equ_w // 8, 1)
    tp[mask] = 4
    tp[np.flip(mask, 0)] = 5

    lon = ((np.linspace(0, equ_w - 1, num=equ_w, dtype=np.float64) + 0.5)
           / equ_w - 0.5) * 2 * np.pi
    lat = -((np.linspace(0, equ_h - 1, num=equ_h, dtype=np.float64) + 0.5)
            / equ_h - 0.5) * np.pi
    lon, lat = np.meshgrid(lon, lat)

    coor_u = np.zeros((equ_h, equ_w), np.float64)
    coor_v = np.zeros((equ_h, equ_w), np.float64)
    for i in range(4):
        m = tp == i
        coor_u[m] = 0.5 * np.tan(lon[m] - np.pi * i / 2)
        coor_v[m] = -0.5 * np.tan(lat[m]) / np.cos(lon[m] - np.pi * i / 2)
    m = tp == 4
    c = 0.5 * np.tan(np.pi / 2 - lat[m])
    coor_u[m] = c * np.sin(lon[m])
    coor_v[m] = c * np.cos(lon[m])
    m = tp == 5
    c = 0.5 * np.tan(np.pi / 2 - np.abs(lat[m]))
    coor_u[m] = c * np.sin(lon[m])
    coor_v[m] = -c * np.cos(lon[m])

    coor_u = np.clip(coor_u, -0.5, 0.5) * 2
    coor_v = np.clip(coor_v, -0.5, 0.5) * 2
    # align_corners=True: [-1, 1] -> [0, fw-1]
    px = (coor_u + 1.0) * 0.5 * (face_w - 1)
    py = (coor_v + 1.0) * 0.5 * (face_w - 1)
    return (tp.astype(np.int32),
            np.stack([px, py], axis=-1).astype(np.float32))


@functools.lru_cache(maxsize=32)
def zdepth_cosine(face_w: int) -> np.ndarray:
    """Per-face-pixel cos factor converting radial distance to z-depth,
    (fw, fw), identical for every face."""
    rng = np.linspace(-0.5, 0.5, num=face_w, dtype=np.float64)
    gx, gy = np.meshgrid(rng, -rng)
    cos = 1.0 / np.sqrt((2 * gx) ** 2 + (2 * gy) ** 2 + 1)
    return np.asarray(cos, dtype=np.float32)


@functools.lru_cache(maxsize=32)
def _grid(kind: str, shape: tuple, device: torch.device) -> torch.Tensor:
    """The sampling grid as a tensor on ``device``, built once per shape
    and device."""
    if kind == "e2c":
        return torch.from_numpy(_e2c_grid(*shape)).to(device)
    fw = shape[0]
    tp, pxy = (torch.from_numpy(a) for a in _c2e_grid(*shape))
    # one tall image (6*fw, fw): clamp the in-face coords so the bilinear
    # taps stay inside the face's row block, offset y by face; float32 as
    # in the JAX package
    px = torch.clamp(pxy[..., 0], 0.0, fw - 1.0)
    py = torch.clamp(pxy[..., 1], 0.0, fw - 1.0) + tp.float() * fw
    return torch.stack([px, py], -1).to(device)


def equi_to_cube(equi: torch.Tensor, face_w: int) -> torch.Tensor:
    """ERP images (B, H, W, C) -> cubemaps (B, 6, fw, fw, C): bilinear,
    longitude-wrapping."""
    b, h, w, _ = equi.shape
    grid = _grid("e2c", (h, w, face_w), equi.device)
    return batched_bilinear_sample(equi, grid.expand(b, *grid.shape))


def cube_to_equi(cube: torch.Tensor, equ_h: int, equ_w: int) -> torch.Tensor:
    """Cubemaps (B, 6, fw, fw, C) -> ERP (B, equ_h, equ_w, C): bilinear
    within the selected face (border clamp); the nearest-face selection
    keeps the 4 taps inside one face."""
    b, six, fw, fw2, c = cube.shape
    assert six == 6 and fw == fw2
    grid = _grid("c2e", (fw, equ_h, equ_w), cube.device)
    return batched_bilinear_sample(cube.reshape(b, 6 * fw, fw, c),
                                   grid.expand(b, *grid.shape), wrap_x=False)


def stacked_to_strip(cube: torch.Tensor) -> torch.Tensor:
    """(6, fw, fw, C) -> horizontal strip (fw, 6*fw, C) [F R B L U D]."""
    return torch.cat(list(cube), dim=1)


def strip_to_stacked(strip: torch.Tensor, face_w: int) -> torch.Tensor:
    """(fw, 6*fw, C) -> (6, fw, fw, C)."""
    return torch.stack(torch.split(strip, face_w, dim=1), dim=0)
