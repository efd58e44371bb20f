"""Spherical-sweep cost volume (vectorised warp-and-diff), forward only.

Port of ``panogrf_tpu/ops/cost_volume.py``.  For each reference pixel with
unit direction d and hypothesis depth t the world point is
R_ref^T (t d - t_ref); its source-camera position R_src w + t_src is
projected to ERP pixel coordinates (pixel-centre grid) and the source
features are sampled there bilinearly (wrap-x, border-y).  The whole
(D, H, W) sweep is one batched gather.  The depth stack is frozen, so
only the forward is ported; the JAX package's matmul-backward sampler is a
device for the sweep's gradient and has the same forward.
"""

from __future__ import annotations

import torch

from panogrf_tpu_torch.core.sphere import SphereConvention
from panogrf_tpu_torch.ops.resample import batched_bilinear_sample


def sweep_coordinates(depth_volume: torch.Tensor, dirs: torch.Tensor,
                      rot_ref: torch.Tensor, tran_ref: torch.Tensor,
                      rot_src: torch.Tensor, tran_src: torch.Tensor,
                      convention: SphereConvention, height: int,
                      width: int) -> tuple:
    """Project reference-view sweep points into the source ERP view.

    :param depth_volume: (..., D, H, W) hypothesis depths; dirs (H, W, 3)
        unit pixel-centre rays of the reference camera; rot_* (..., 3, 3)
        and tran_* (..., 3) world-to-camera (x_cam = R x_w + t), with the
        same leading axes as ``depth_volume``.
    :return: (uv (..., D, H, W, 2) source pixel coords, src distance
        (..., D, H, W)).
    """
    lead = depth_volume.shape[:-3]
    pts_ref = depth_volume[..., None] * dirs            # (..., D, H, W, 3)
    rr, tr, rs, ts = (t.reshape(*lead, 1, 1, 1, *t.shape[len(lead):])
                      for t in (rot_ref, tran_ref, rot_src, tran_src))
    # cam -> world: w = R_ref^T (p - t_ref); world -> src cam
    wpt = torch.einsum("...ji,...j->...i", rr, pts_ref - tr)
    cam = torch.einsum("...ij,...j->...i", rs, wpt) + ts
    return convention.project_to_pixels(cam, height, width, mode="center")


def dirs_for(convention: SphereConvention, h: int, w: int,
             device=None) -> torch.Tensor:
    """Pixel-centre unit ray directions (the sweep grid), (h, w, 3)."""
    return convention.ray_directions(h, w, device, mode="center")


def _cost(warped: torch.Tensor, ref_feats: torch.Tensor,
          cost_type: str) -> torch.Tensor:
    if cost_type == "abs_diff":
        return torch.abs(warped - ref_feats)
    if cost_type == "dot":
        return warped * ref_feats
    if cost_type == "none":
        return warped
    raise ValueError(f"unknown cost type {cost_type!r}")


def spherical_sweep_cost(ref_feats: torch.Tensor, src_feats: torch.Tensor,
                         depth_volume: torch.Tensor, rot_ref: torch.Tensor,
                         tran_ref: torch.Tensor, rot_src: torch.Tensor,
                         tran_src: torch.Tensor,
                         convention: SphereConvention,
                         cost_type: str = "abs_diff") -> torch.Tensor:
    """Cost volume of one (ref, src) pair: feats (H, W, C), depth_volume
    (D, H, W), poses (3, 3) / (3,) -> (D, H, W, C)."""
    rots = torch.stack([rot_src, rot_ref])[None]
    trans = torch.stack([tran_src, tran_ref])[None]
    return batched_sweep_cost(ref_feats[None], src_feats[None],
                              depth_volume[None], rots, trans, convention,
                              cost_type)[0]


@torch.no_grad()
def batched_sweep_cost(ref_feats: torch.Tensor, src_feats: torch.Tensor,
                       depth_volume: torch.Tensor, rots: torch.Tensor,
                       trans: torch.Tensor, convention: SphereConvention,
                       cost_type: str = "abs_diff") -> torch.Tensor:
    """Two-view cost volume in the reference input layout: feats
    (B, H, W, C), depth_volume (B, D, H, W), rots (B, 2, 3, 3) and trans
    (B, 2, 3) with index 0 = src, 1 = ref -> (B, D, H, W, C)."""
    _, h, w, _ = ref_feats.shape
    uv, _ = sweep_coordinates(depth_volume,
                              dirs_for(convention, h, w, ref_feats.device),
                              rots[:, 1], trans[:, 1], rots[:, 0],
                              trans[:, 0], convention, h, w)
    warped = batched_bilinear_sample(src_feats, uv)         # (B, D, H, W, C)
    return _cost(warped, ref_feats[:, None], cost_type)
