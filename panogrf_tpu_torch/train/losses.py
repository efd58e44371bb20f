"""Losses of renderer and depth-network training.

Port of ``panogrf_tpu/train/losses.py``.  Renderer losses are functions
(data_pr, data_gt, step) -> dict of per-sample losses, and the trainer
sums the mean of every ``*loss*`` entry (``NAME2LOSS``, ``total_loss``).
The depth-network losses (``l1_sphere_loss``, ``berhu_loss``,
``gaussian_nll_loss``, ``laplacian_nll_loss``) take channel-last
(B, H, W, 1) maps and return a scalar.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from panogrf_tpu_torch.ops.resample import interpolate_feats


def _masked_rgb_loss(rgb_pr: torch.Tensor, rgb_gt: torch.Tensor,
                     ray_mask: torch.Tensor | None,
                     polar_weights: torch.Tensor | None) -> torch.Tensor:
    loss = torch.sum((rgb_pr - rgb_gt) ** 2, -1)             # (qn, rn)
    if polar_weights is not None:
        w = polar_weights[..., 0] if polar_weights.dim() == 3 \
            else polar_weights
        loss = loss * w
        if ray_mask is not None:
            m = ray_mask.to(loss.dtype)
            return torch.sum(loss * m, 1) / (torch.sum(m * w, 1) + 1e-7)
        return torch.sum(loss, 1) / (torch.sum(w, 1) + 1e-7)
    if ray_mask is not None:
        m = ray_mask.to(loss.dtype)
        return torch.sum(loss * m, 1) / (torch.sum(m, 1) + 1e-7)
    return torch.mean(loss, 1)


def render_loss(data_pr: dict, data_gt: dict, step: int = 0, *,
                use_ray_mask: bool = True, use_nr_fine_loss: bool = True,
                use_polar_weighted_loss: bool = False) -> dict:
    """Coarse + fine masked MSE of the rendered colours."""
    rgb_gt = data_pr["pixel_colors_gt"]
    mask = data_pr.get("ray_mask") if use_ray_mask else None
    pw = data_pr.get("polar_weights") if use_polar_weighted_loss else None
    out = {"loss_rgb_nr": _masked_rgb_loss(
        data_pr["pixel_colors_nr"], rgb_gt, mask, pw)}
    if use_nr_fine_loss and "pixel_colors_nr_fine" in data_pr:
        out["loss_rgb_nr_fine"] = _masked_rgb_loss(
            data_pr["pixel_colors_nr_fine"], rgb_gt, mask, pw)
    return out


def normalize_inv_depth(depth: torch.Tensor,
                        depth_range: torch.Tensor) -> torch.Tensor:
    """Depth -> normalized inverse depth given per-view (near, far)."""
    near = -1.0 / depth_range[:, 0:1]
    far = -1.0 / depth_range[:, 1:2]
    d = -1.0 / torch.clamp(depth, min=1e-5)
    return torch.clamp((d - near) / (far - near), 0.0, 1.0)


def depth_loss(data_pr: dict, data_gt: dict, step: int = 0, *,
               loss_type: str = "l2", smooth_l1_beta: float = 0.05) -> dict:
    """Supervise the decoder's expected depth with the reference views'
    true depth (``ref_imgs_info.true_depth``) at ``depth_coords``."""
    if "depth_mean" not in data_pr:
        return {}
    ref = data_gt["ref_imgs_info"]
    if "true_depth" not in ref:
        return {"loss_depth": torch.zeros(())}
    h, w = ref["true_depth"].shape[1:3]
    depth_gt = interpolate_feats(ref["true_depth"], data_pr["depth_coords"],
                                 h, w)[..., 0]
    depth_gt = normalize_inv_depth(depth_gt, ref["depth_range"])

    def one(pred):
        if loss_type == "l2":
            per = (depth_gt - pred) ** 2
        else:  # smooth_l1
            diff = torch.abs(depth_gt - pred)
            per = torch.where(diff < smooth_l1_beta,
                              0.5 * diff ** 2 / smooth_l1_beta,
                              diff - 0.5 * smooth_l1_beta)
        return torch.mean(per, 1)

    out = {"loss_depth": one(data_pr["depth_mean"])}
    if "depth_mean_fine" in data_pr:
        out["loss_depth_fine"] = one(data_pr["depth_mean_fine"])
    return out


def consistency_loss(data_pr: dict, data_gt: dict, step: int = 0) -> dict:
    """Cross entropy between the rendered and the self-predicted hit
    probability (the rendered one is the target)."""
    if "hit_prob_self" not in data_pr:
        return {}

    def ce(p0, p1):
        p0 = p0.detach()
        v = -p0 * torch.log(p1 + 1e-5) - (1 - p0) * torch.log(1 - p1 + 1e-5)
        return torch.mean(torch.mean(v, -1), 1)
    out = {"loss_prob": ce(data_pr["hit_prob_nr"], data_pr["hit_prob_self"])}
    if "hit_prob_nr_fine" in data_pr and "hit_prob_self_fine" in data_pr:
        out["loss_prob_fine"] = ce(data_pr["hit_prob_nr_fine"],
                                   data_pr["hit_prob_self_fine"])
    return out


NAME2LOSS: Dict[str, Callable] = {
    "render": render_loss,
    "depth": depth_loss,
    "consistency": consistency_loss,
}


def total_loss(loss_terms: dict) -> torch.Tensor:
    """Sum of the mean of every ``*loss*`` entry."""
    total = torch.zeros(())
    for k, v in loss_terms.items():
        if "loss" in k:
            total = total + torch.mean(v)
    return total


# ---------------------------------------------------------------------------
# depth-network losses (mono / MVS training)
# ---------------------------------------------------------------------------

def sin_phi_map(height: int, width: int, device=None) -> torch.Tensor:
    """sin of each ERP row's polar angle at the pixel centre, (H, W)."""
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        * (math.pi / height)
    return torch.sin(v)[:, None].expand(height, width)


def l1_sphere_loss(pred: torch.Tensor, gt: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
    """sin(phi)-weighted L1 of (B, H, W, 1) maps; ``mask`` optional
    validity of the same shape."""
    b, h, w, _ = pred.shape
    wmap = sin_phi_map(h, w, pred.device)[None, :, :, None]
    diff = torch.abs(pred - gt) * wmap
    if mask is not None:
        return torch.sum(diff * mask) / (torch.sum(mask * wmap) + 1e-7)
    return torch.sum(diff) / (torch.sum(wmap) * b + 1e-7)


def berhu_loss(pred: torch.Tensor, gt: torch.Tensor,
               mask: torch.Tensor | None = None,
               threshold: float = 0.2) -> torch.Tensor:
    """Reverse Huber: L1 below ``threshold`` x the largest error, scaled
    L2 above it."""
    diff = torch.abs(pred - gt)
    if mask is not None:
        diff = diff * mask
    delta = threshold * torch.max(diff)
    part1 = torch.where(diff <= delta, diff, 0.0)
    part2 = torch.where(diff > delta,
                        (diff ** 2 + delta ** 2) / (2 * delta + 1e-9), 0.0)
    denom = torch.sum(mask) + 1e-7 if mask is not None else diff.numel()
    return torch.sum(part1 + part2) / denom


def gaussian_nll_loss(mu: torch.Tensor, sigma: torch.Tensor,
                      gt: torch.Tensor, mask: torch.Tensor | None = None,
                      sin_weighted: bool = True) -> torch.Tensor:
    """Gaussian negative log-likelihood of ``gt`` under (mu, sigma), the
    variance floored at 1e-6, optionally sin(phi)-weighted."""
    var = torch.clamp(sigma ** 2, min=1e-6)
    nll = 0.5 * (torch.log(var) + (gt - mu) ** 2 / var)
    if sin_weighted:
        h, w = mu.shape[1:3]
        nll = nll * sin_phi_map(h, w, mu.device)[None, :, :, None]
    if mask is not None:
        return torch.sum(nll * mask) / (torch.sum(mask) + 1e-7)
    return torch.mean(nll)


def laplacian_nll_loss(mu: torch.Tensor, b_scale: torch.Tensor,
                       gt: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Laplacian negative log-likelihood, the scale floored at 1e-4."""
    b_ = torch.clamp(b_scale, min=1e-4)
    nll = torch.log(2 * b_) + torch.abs(gt - mu) / b_
    if mask is not None:
        return torch.sum(nll * mask) / (torch.sum(mask) + 1e-7)
    return torch.mean(nll)
