"""Panorama training augmentations.

Port of ``panogrf_tpu/data/augment.py`` (reference
``data_readers/habitat_data_neuray_ft_lmdb.py:56-84,112-194``): a yaw roll
(circular longitude shift with the matching rotation of the poses) and a
photometric jitter (gamma, brightness and per-channel colour), each the
same for every view of a sample.  The draws come from an explicit
``torch.Generator`` (``jitter_draws``, ``augment_sample``); the arithmetic
takes them as arguments.  ``jitter_rotation`` is the legacy Euler-angle
pose jitter, on a numpy generator.  No CLI applies them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def yaw_roll(sample: dict, shift_px: int) -> dict:
    """Circularly shift every panorama of ``sample`` (tensors, rgb_panos /
    depth_panos (V, H, W, C)) by ``shift_px`` columns and rotate the
    world-to-camera rotations by the same yaw, so poses stay consistent."""
    w = sample["rgb_panos"].shape[2]
    ang = 2.0 * math.pi * shift_px / w
    c, s = math.cos(ang), math.sin(ang)
    rots = sample["rots"]
    # m3d convention: yaw about the +y axis
    r_yaw = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                         dtype=torch.float32, device=rots.device)
    out = dict(sample)
    out["rgb_panos"] = torch.roll(sample["rgb_panos"], shift_px, dims=2)
    out["depth_panos"] = torch.roll(sample["depth_panos"], shift_px, dims=2)
    # w2c' = R_yaw @ w2c: shifting the pixels rotates the camera
    out["rots"] = torch.einsum("ij,vjk->vik", r_yaw, rots)
    return out


def jitter_draws(generator: torch.Generator, gamma_range=(0.8, 1.2),
                 bright_range=(0.8, 1.2), color_range=(0.9, 1.1)) -> tuple:
    """(gamma (), brightness (), colour (3,)) drawn uniformly from their
    ranges on ``generator`` (on its device)."""
    def draw(shape, lo, hi):
        u = torch.rand(shape, generator=generator,
                       device=generator.device)
        return lo + (hi - lo) * u
    return (draw((), *gamma_range), draw((), *bright_range),
            draw((3,), *color_range))


def photometric_jitter(sample: dict, gamma, bright, color) -> dict:
    """``clip(clip(rgb, 1e-4, 1) ** gamma * bright * color, 0, 1)`` on
    every view's rgb_panos, the draws the same for all views."""
    rgb = sample["rgb_panos"]

    def like(v):
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, np.float32))
        return v.to(rgb)
    out = dict(sample)
    x = torch.clamp(rgb, 1e-4, 1.0) ** like(gamma) * like(bright) \
        * like(color)
    out["rgb_panos"] = torch.clamp(x, 0.0, 1.0)
    return out


def augment_sample(sample: dict, generator: torch.Generator,
                   max_shift: int | None = None) -> dict:
    """Yaw roll by a shift drawn from [0, ``max_shift`` or W), then the
    photometric jitter.  (A left-right flip would mirror the world and its
    pose handedness; the reference applies it only in its LMDB
    depth-training path, and it is left out here.)"""
    w = sample["rgb_panos"].shape[2]
    shift = int(torch.randint(0, max_shift or w, (), generator=generator,
                              device=generator.device))
    out = yaw_roll(sample, shift)
    return photometric_jitter(out, *jitter_draws(generator))


def jitter_rotation(rot: np.ndarray, rng: np.random.Generator,
                    angle_deg: float = 30.0) -> np.ndarray:
    """Perturb each zyz Euler angle of the (3, 3) rotation ``rot`` by
    U(-angle/2, +angle/2) degrees drawn from ``rng`` (reference
    ``mutils/jitter.py:6-18``, the legacy SynSin augmentation)."""

    def to_euler(r):
        beta = np.arccos(np.clip(r[2, 2], -1.0, 1.0))
        if abs(r[2, 2]) > 1 - 1e-8:
            return np.asarray([np.arctan2(r[1, 0], r[0, 0]), beta, 0.0])
        alpha = np.arctan2(r[1, 2], r[0, 2])
        gamma = np.arctan2(r[2, 1], -r[2, 0])
        return np.asarray([alpha, beta, gamma])

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    e = to_euler(np.asarray(rot, np.float64))
    e = e + (rng.random(3) - 0.5) * np.pi * angle_deg / 180.0
    return (rz(e[0]) @ ry(e[1]) @ rz(e[2])).astype(np.float32)
