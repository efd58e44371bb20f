"""Depth supervision losses of per-scene finetuning.

Port of ``panogrf_tpu/train/ft_losses.py``: the Gaussian NLL and the
per-point hit-probability loss against the cached MVS depth and
variance, the Urban Radiance Fields depth loss, the autoencoder's
multi-scale reconstruction loss and ``depth_ft_loss``, the ``depth_ft``
entry of ``losses.NAME2LOSS``.  Ray-batch tensors are (qn, rn) per ray
and (qn, rn, dn) per sample.
"""

from __future__ import annotations

import math

import torch


def is_not_in_expected_distribution(mean: torch.Tensor, var: torch.Tensor,
                                    m_mean: torch.Tensor,
                                    m_var: torch.Tensor) -> torch.Tensor:
    """Where the prediction disagrees with the measurement: farther than
    one measured sigma, or with a larger variance."""
    delta_bad = (torch.abs(mean - m_mean) - torch.sqrt(m_var)) > 0.0
    return delta_bad | (m_var < var)


def nll_depth_loss(pred_mean: torch.Tensor, pred_var: torch.Tensor,
                   target_mean: torch.Tensor, target_var: torch.Tensor,
                   min_depth: float, max_depth: float,
                   apply_all: bool = False, clip_sigma: float = 0.0,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Gaussian NLL of the rendered depth against the cached MVS depth,
    on the rays the gate selects inside (min_depth, max_depth); the
    predicted sigma floored at ``clip_sigma``.  Shapes (qn, rn) -> (qn,).
    """
    pv = torch.square(torch.clamp(torch.sqrt(torch.clamp(pred_var, min=0.0)),
                                  min=clip_sigma))
    if apply_all:
        gate = torch.ones_like(pred_mean, dtype=torch.bool)
    else:
        gate = is_not_in_expected_distribution(pred_mean, pv, target_mean,
                                               target_var)
    gate = gate & (target_mean > min_depth) & (target_mean < max_depth)
    gate = gate.to(pred_mean.dtype)
    var = torch.clamp(pv, min=1e-3)
    nll = 0.5 * (torch.log(var) + (pred_mean - target_mean) ** 2 / var)
    w = gate if weights is None else gate * weights
    return torch.sum(nll * w, 1) / (torch.sum(w, 1) + 1e-7)


def perpoint_depth_loss(weights: torch.Tensor, tvals: torch.Tensor,
                        target_depth: torch.Tensor,
                        target_var: torch.Tensor, min_depth: float,
                        sigma_factor: float = 1.0) -> torch.Tensor:
    """Squared distance of each ray's hit probabilities ``weights``
    (qn, rn, dn) at depths ``tvals`` from a normalised Gaussian bump at the
    measured depth; rays below ``min_depth`` are left out.  -> (qn,)."""
    d_t = target_depth[..., None]
    sigma = torch.sqrt(torch.clamp(target_var, min=1e-8))[..., None] \
        * sigma_factor
    mask_valid = (d_t >= min_depth).to(weights.dtype)
    target_w = torch.exp(-0.5 * ((tvals - d_t) / sigma) ** 2)
    target_w = target_w / (torch.sum(target_w, -1, keepdim=True) + 1e-8)
    loss = torch.sum((weights - target_w) ** 2 * mask_valid, -1)
    return torch.mean(loss, 1)


def urf_depth_loss(depth_pr: torch.Tensor, tvals: torch.Tensor,
                   weights: torch.Tensor, target_depth: torch.Tensor,
                   target_var: torch.Tensor, min_depth: float) -> tuple:
    """Urban Radiance Fields depth loss: expected-depth MSE, hit
    probabilities matched to a Gaussian within 3 sigma of the measured
    depth, and suppressed outside it.

    :return: (d_loss, n_loss, e_loss), each (qn,).
    """
    var_t = target_var[..., None].expand(tvals.shape)
    sigma = torch.sqrt(torch.clamp(var_t, min=1e-10))
    eps = sigma * 3.0
    valid = target_depth >= min_depth
    d_loss = torch.mean(((depth_pr - target_depth) * valid) ** 2, -1)
    d_t = target_depth[..., None].expand(tvals.shape)
    dmask = d_t >= min_depth
    near = (tvals > (d_t - eps)) & (tvals < (d_t + eps)) & dmask
    empty = ((tvals > (d_t + eps)) | (tvals < (d_t - eps))) & dmask
    dist = torch.where(near, tvals - d_t, torch.zeros_like(tvals))
    distr = (1.0 / (sigma * math.sqrt(2 * math.pi))
             * torch.exp(-(dist ** 2) / (2 * sigma ** 2)))
    distr = distr / (torch.max(distr) + 1e-12)
    distr = distr * near
    n_loss = torch.mean(torch.sum(near * (weights - distr) ** 2, -1), -1)
    e_loss = torch.mean(torch.sum((empty * weights) ** 2, -1), -1)
    return d_loss, n_loss, e_loss


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) weights of ``jax.image.resize``'s bilinear method
    (triangle kernel, widened by the scale when downsampling, each row
    normalised; half-pixel centres)."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    f32 = torch.float32
    sample_f = (torch.arange(n_out, dtype=f32, device=device) + 0.5) \
        / scale - 0.5
    x = torch.abs(sample_f[:, None]
                  - torch.arange(n_in, dtype=f32, device=device)[None]) \
        / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = torch.sum(w, 1, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * torch.finfo(f32).eps,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return w * inside[:, None]


def resize_bilinear(img: torch.Tensor, hw: tuple) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C), as ``jax.image.resize(..., "bilinear")``
    (antialiased when shrinking)."""
    wy = _resize_weights(img.shape[1], hw[0], img.device)
    wx = _resize_weights(img.shape[2], hw[1], img.device)
    return torch.einsum("yh,xw,bhwc->byxc", wy, wx, img)


def ae_recon_loss(pred_imgs: dict, gt_img: torch.Tensor) -> torch.Tensor:
    """Multi-scale autoencoder reconstruction: the mean L1 of each
    {scale: (B, h, w, 3)} prediction against ``gt_img`` (B, H, W, 3)
    resized to its size, averaged over the scales."""
    total = torch.zeros((), device=gt_img.device)
    for pred in pred_imgs.values():
        gt = resize_bilinear(gt_img, pred.shape[1:3])
        total = total + torch.mean(torch.abs(pred - gt))
    return total / max(len(pred_imgs), 1)


def depth_ft_loss(data_pr: dict, data_gt: dict, step: int = 0, *,
                  loss_type: str = "mse", min_depth: float = 0.5,
                  max_depth: float = 15.0) -> dict:
    """The rendered depth of each pass (coarse, ``_fine``) against the
    cached MVS depth of the query view at the rays,
    ``que_imgs_info.mvs_depth_at_coords`` (qn, rn), and its variance
    ``mvs_var_at_coords`` (0.01 if absent): ``loss_type`` 'mse', 'nll'
    (with ``render_uncert``), 'perpoint' or 'urf'.  No term without the
    cached depth or a rendered depth."""
    que = data_gt.get("que_imgs_info", {})
    if "mvs_depth_at_coords" not in que or "render_depth" not in data_pr:
        return {}
    tgt = que["mvs_depth_at_coords"]
    var = que.get("mvs_var_at_coords")
    if var is None:
        var = torch.full_like(tgt, 0.01)
    out = {}
    for suffix in ("", "_fine"):
        if f"render_depth{suffix}" not in data_pr:
            continue
        pred = data_pr[f"render_depth{suffix}"]
        if loss_type == "mse":
            valid = ((tgt > min_depth) & (tgt < max_depth)).to(pred.dtype)
            loss = torch.sum((pred - tgt) ** 2 * valid, 1) \
                / (torch.sum(valid, 1) + 1e-7)
        elif loss_type == "nll":
            loss = nll_depth_loss(pred, data_pr.get(f"render_uncert{suffix}"),
                                  tgt, var, min_depth, max_depth)
        elif loss_type == "perpoint":
            loss = perpoint_depth_loss(data_pr[f"hit_prob_nr{suffix}"],
                                       data_pr[f"que_depth{suffix}"], tgt,
                                       var, min_depth)
        elif loss_type == "urf":
            d, n, e = urf_depth_loss(pred, data_pr[f"que_depth{suffix}"],
                                     data_pr[f"hit_prob_nr{suffix}"], tgt,
                                     var, min_depth)
            loss = d + n + e
        else:
            raise ValueError(loss_type)
        out[f"loss_depth_ft{suffix}"] = loss
    return out
