"""Bilinear resampling of channel-last ERP feature maps.

Frozen from the port's ``ops/resample.py``: pixel coordinates with
align-corners semantics and border clamping in y; x wraps (ERP longitude)
or is clamped like y.  ``F.grid_sample`` does not wrap x, so the 2x2
window is fetched by hand.  The ``zeros`` padding mode zeroes points more
than a pixel outside the map.
"""

from __future__ import annotations

import torch


def batched_bilinear_sample(imgs: torch.Tensor, xy: torch.Tensor,
                            wrap_x: bool = True,
                            pad_mode: str = "border") -> torch.Tensor:
    """Sample ``imgs`` (B, H, W, C) at pixel coords ``xy`` (B, ..., 2).

    Reads exactly the taps of the JAX package's padded 2x2 window: the
    row after H-1 is row H-1, and the column after W-1 is column 0 with
    ``wrap_x`` and column W-1 without.  Its ``lax.gather`` clamps the
    window start into the map, so an x whose wrap rounds up to exactly W
    starts at W-1 with ``tx = 0``; that clamp is reproduced here.
    ``pad_mode="zeros"`` zeroes the points with y outside [-1, H] (and,
    without ``wrap_x``, x outside [-1, W]): the JAX package's window start
    is clamped into the map, so only those lose every tap.
    :return: (B, ..., C) in the maps' dtype.
    """
    if pad_mode not in ("border", "zeros"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    b, h, w, c = imgs.shape
    if wrap_x:
        x = torch.remainder(xy[..., 0], 1.0 * w)
    else:
        x = torch.clamp(xy[..., 0], 0.0, w - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    tx = (x - x0f)[..., None].to(imgs.dtype)
    ty = (y - y0f)[..., None].to(imgs.dtype)
    x0 = x0f.long().clamp_(0, w - 1)
    y0 = y0f.long().clamp_(0, h - 1)
    if wrap_x:
        x1 = torch.where(x0 + 1 == w, 0, x0 + 1)
    else:
        x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    base = torch.arange(b, device=imgs.device).view(
        b, *([1] * (x0.dim() - 1))) * (h * w)
    flat = imgs.reshape(b * h * w, c)
    r0 = base + y0 * w
    r1 = base + y1 * w
    top = flat[r0 + x0] * (1 - tx) + flat[r0 + x1] * tx
    bot = flat[r1 + x0] * (1 - tx) + flat[r1 + x1] * tx
    out = top * (1 - ty) + bot * ty
    if pad_mode == "zeros":
        yr = xy[..., 1]
        mask = (yr >= -1.0) & (yr <= float(h))
        if not wrap_x:
            xr = xy[..., 0]
            mask = mask & (xr >= -1.0) & (xr <= float(w))
        out = out * mask[..., None].to(out.dtype)
    return out


def _rescale(points: torch.Tensor, fh: int, fw: int, h: int,
             w: int) -> torch.Tensor:
    """Pixel coords of an (h, w) frame -> the (fh, fw) map's frame
    (align-corners)."""
    if fh == h and fw == w:
        return points
    scale = torch.tensor([(fw - 1.0) / (w - 1.0), (fh - 1.0) / (h - 1.0)],
                         dtype=points.dtype, device=points.device)
    return points * scale


def interpolate_feats(feats: torch.Tensor, points: torch.Tensor, h: int,
                      w: int) -> torch.Tensor:
    """Sample (B, fh, fw, C) maps at (B, N, 2) pixel coords given in an
    (h, w) frame; coords are rescaled when the map's size differs."""
    _, fh, fw, _ = feats.shape
    return batched_bilinear_sample(feats, _rescale(points, fh, fw, h, w))


def interpolate_feats_pointmajor(feats: torch.Tensor, pts: torch.Tensor,
                                 h: int, w: int) -> torch.Tensor:
    """Multi-view sampling: feats (V, fh, fw, C), pts (V, pn, 2) in the
    (h, w) frame -> point-major (pn, V, C)."""
    return interpolate_feats(feats, pts, h, w).transpose(0, 1)
