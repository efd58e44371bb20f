"""Image metrics of the renderer's validation and evaluation.

Port of the image half of ``panogrf_tpu/train/metrics.py``: PSNR, the
sin(phi)-weighted spherical WS-PSNR and tf.image.ssim-compatible SSIM
(Gaussian window 11, sigma 1.5, valid-mode separable filter), under the
key names of ``render_metrics``.  The depth metrics come with depth
training.  Tensors are channel-last (..., H, W, C) in [0, max_val].
"""

from __future__ import annotations

import math

import torch


def psnr(pred: torch.Tensor, gt: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2, dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-10))


def ws_psnr(pred: torch.Tensor, gt: torch.Tensor,
            max_val: float = 1.0) -> torch.Tensor:
    """PSNR with each row's squared error weighted by sin(phi)."""
    h = pred.shape[-3]
    v = (torch.arange(h, dtype=pred.dtype, device=pred.device) + 0.5) \
        * (math.pi / h)
    w = torch.sin(v)[:, None, None]
    se = (pred - gt) ** 2
    wmse = torch.sum(se * w, dim=(-3, -2, -1)) \
        / torch.sum(w.expand(pred.shape[-3:]))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(wmse, min=1e-10))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) \
        - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / torch.sum(g)


def _filter2d_sep(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode filter over (H, W) of an (H, W, C) image, as a
    sum of shifted slices: full float32 products even where a convolution
    would run in TF32 (the E[x^2] - mu^2 variance cancels badly)."""
    def conv_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
        n = x.shape[axis] - k.numel() + 1
        return sum(k[i] * x.narrow(axis, i, n) for i in range(k.numel()))
    return conv_axis(conv_axis(img, 0), 1)


def ssim(pred: torch.Tensor, gt: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """tf.image.ssim-compatible SSIM of (H, W, C) images."""
    k = _gaussian_kernel(device=pred.device)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_x = _filter2d_sep(pred, k)
    mu_y = _filter2d_sep(gt, k)
    xx = _filter2d_sep(pred * pred, k) - mu_x * mu_x
    yy = _filter2d_sep(gt * gt, k) - mu_y * mu_y
    xy = _filter2d_sep(pred * gt, k) - mu_x * mu_y
    lum = (2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)
    cs = (2 * xy + c2) / (xx + yy + c2)
    return torch.mean(lum * cs)


def render_metrics(pred_img: torch.Tensor, gt_img: torch.Tensor) -> dict:
    """The validation metric dict (key names of the reference's
    ``network/metrics.py``)."""
    return {"psnr_nr": psnr(pred_img, gt_img),
            "ssim_nr": ssim(pred_img, gt_img),
            "wspsnr_nr": ws_psnr(pred_img, gt_img)}
