"""Image and depth metrics of validation and evaluation.

Port of ``panogrf_tpu/train/metrics.py``: PSNR, the sin(phi)-weighted
spherical WS-PSNR and tf.image.ssim-compatible SSIM (Gaussian window 11,
sigma 1.5, valid-mode separable filter), under the key names of
``render_metrics``; images are channel-last (..., H, W, C) in
[0, max_val].  The ERP depth metric tables (``depth_metrics_erp``,
``depth_metrics_erp_full``) and the cube-face z-depth table
(``depth_metrics_zdepth``, with ``distance_to_zdepth``) take (H, W) or
(H, W, 1) distances in metres.
"""

from __future__ import annotations

import math

import torch

from panogrf_tpu_torch.core.cubemap import equi_to_cube


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


# ---------------------------------------------------------------------------
# depth metrics
# ---------------------------------------------------------------------------

_RELATIVE = (("relative_105", 1.05), ("relative_110", 1.10),
             ("relative_125", 1.25), ("relative_125_2", 1.25 ** 2),
             ("relative_125_3", 1.25 ** 3))


def _sin_rows(h: int, w: int, device) -> torch.Tensor:
    v = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) \
        * (math.pi / h)
    return torch.sin(v)[:, None].expand(h, w)


def _hw(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1]).float()


def depth_metrics_erp(pred: torch.Tensor, gt: torch.Tensor,
                      min_depth: float = 0.1,
                      max_depth: float = 10.0) -> dict:
    """sin(phi)-weighted MAE, RMSE, AbsRel and the delta thresholds over
    the pixels whose true depth lies in (min_depth, max_depth); the
    prediction is clipped to that range."""
    pred, gt = _hw(pred), _hw(gt)
    h, w = gt.shape
    valid = ((gt > min_depth) & (gt < max_depth)).float()
    wv = _sin_rows(h, w, gt.device) * valid
    denom = torch.sum(wv) + 1e-7
    pred = torch.clamp(pred, min_depth, max_depth)
    abs_err = torch.abs(pred - gt)
    ratio = torch.maximum(pred / torch.clamp(gt, min=1e-6),
                          gt / torch.clamp(pred, min=1e-6))
    out = {"mae": torch.sum(abs_err * wv) / denom,
           "rmse": torch.sqrt(torch.sum((pred - gt) ** 2 * wv) / denom),
           "abs_rel": torch.sum(abs_err / torch.clamp(gt, min=1e-6) * wv)
           / denom}
    for i, name in enumerate(("delta1", "delta2", "delta3")):
        out[name] = torch.sum((ratio < 1.25 ** (i + 1)).float() * wv) / denom
    return out


def _error_table(gt: torch.Tensor, pred: torch.Tensor,
                 valid: torch.Tensor) -> dict:
    """l1/l2/rmse, inverse-depth imae/irmse and the relative-error
    fractions over ``valid`` pixels.  ``l2_error`` sums the squared
    error over ALL pixels while dividing by the valid count, as the
    reference does."""
    vsum = torch.sum(valid) + 1e-7

    def inv(d):
        return torch.where(valid > 0, 1.0 / torch.clamp(d, min=1e-6), 0.0)
    out = {"l1_error": torch.sum(torch.abs(gt - pred) * valid) / vsum,
           "l2_error": torch.sum((gt - pred) ** 2) / vsum,
           "imae_error": torch.sum(torch.abs(inv(gt) - inv(pred)) * valid)
           / vsum,
           "irmse_error": torch.sqrt(
               torch.sum((inv(gt) - inv(pred)) ** 2 * valid) / vsum)}
    out["rmse_error"] = torch.sqrt(out["l2_error"])
    rel = torch.abs(gt - pred) / torch.clamp(gt, min=1e-6) * valid
    for name, t in _RELATIVE:
        out[name] = torch.sum(((rel < t - 1.0) & (valid > 0)).float()) / vsum
    return out


def depth_metrics_erp_full(pred: torch.Tensor, gt: torch.Tensor,
                           min_depth: float = 0.1,
                           max_depth: float = 10.0) -> dict:
    """The reference's ERP depth table: unweighted l1/l2/rmse (``l2``
    deliberately unmasked), sin(phi)-weighted wl1/wl2/wrmse, inverse-depth
    imae/irmse and the relative-error fractions relative_{105, 110, 125,
    125_2, 125_3} (relative error below threshold - 1)."""
    pred, gt = _hw(pred), _hw(gt)
    h, w = gt.shape
    valid = ((gt > min_depth) & (gt < max_depth)).float()
    mw = _sin_rows(h, w, gt.device) * valid
    mwsum = torch.sum(mw) + 1e-7
    out = _error_table(gt, pred, valid)
    out["wl1_error"] = torch.sum(torch.abs(gt - pred) * mw) / mwsum
    out["wl2_error"] = torch.sum((gt - pred) ** 2 * mw) / mwsum
    out["wrmse_error"] = torch.sqrt(out["wl2_error"])
    return out


def distance_to_zdepth(distance: torch.Tensor) -> torch.Tensor:
    """ERP radial distance -> z-depth of the cube face each pixel falls
    on; (H, W) or (H, W, 1)."""
    squeeze = distance.shape[-1] == 1
    d = distance[..., 0] if squeeze else distance
    h, w = d.shape[-2:]
    dev = d.device
    theta = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) \
        * (2 * math.pi / w)
    phi = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) \
        * (math.pi / h)
    pp, tt = torch.meshgrid(phi, theta, indexing="ij")
    dirs = torch.stack([torch.sin(pp) * torch.sin(tt), torch.cos(pp),
                        torch.sin(pp) * torch.cos(tt)], -1)
    m = torch.clamp(torch.max(torch.abs(dirs), -1).values, min=1e-6)
    cw = h // 2
    k = (cw - 1.0) / cw
    out = d / torch.sqrt(1.0 + (1.0 / m ** 2 - 1.0) * k * k)
    return out[..., None] if squeeze else out


def depth_metrics_zdepth(pred: torch.Tensor, gt: torch.Tensor,
                         min_depth: float = 0.1,
                         max_depth: float = 10.0) -> dict:
    """The cube-face z-depth table: distances become z-depth, are
    resampled onto the four lateral cube faces and scored
    (l1/l2/rmse/imae/irmse and the relative fractions) where
    0.1 < z < max_depth."""
    def faces(x):
        z = distance_to_zdepth(x.reshape(*x.shape[:2], -1)[..., :1])
        return equi_to_cube(z[None], gt.shape[0] // 2)[0, :4, ..., 0]
    pc, gc = faces(pred), faces(gt)
    valid = ((gc > 0.1) & (gc < max_depth)).float()
    return _error_table(gc, pc, valid)
