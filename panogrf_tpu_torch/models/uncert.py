"""Uncertainty head over a frozen depth network.

Port of ``panogrf_tpu/models/uncert.py``: a small trainable head that
predicts a per-pixel depth sigma from a frozen net's features and depth,
trained with the Gaussian NLL against the ground-truth depth (the
``mvs_uncert`` maps of DINER sampling and the ft renderer's 3-sigma
guidance).  The base net runs outside, without a graph.  Parameter names
are the port's own (``conv``, ``res``, ``out``); channel-last in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.nn.blocks import (ResidualBlock, WrapConv,
                                         resize_linear)


class DepthUncertHead(nn.Module):
    """(features (B, h, w, C), depth (B, H, W, 1)) -> sigma (B, H, W, 1):
    the depth resized to the features' grid and appended, a 3x3 conv and
    ReLU, a residual block, a 1x1 conv, softplus + ``min_sigma``, resized
    back to the depth's grid."""

    def __init__(self, in_channels: int, hidden: int = 32, wrap: bool = True,
                 min_sigma: float = 1e-3):
        super().__init__()
        self.conv = WrapConv(in_channels + 1, hidden, 3, wrap=wrap)
        self.res = ResidualBlock(hidden, wrap)
        self.out = nn.Conv2d(hidden, 1, 1)
        self.min_sigma = min_sigma

    def forward(self, features: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
        bh, bw = depth.shape[1:3]
        d_small = resize_linear(depth, features.shape[1:3], axes=(1, 2))
        x = torch.cat([features, d_small], -1).permute(0, 3, 1, 2)
        x = self.out(self.res(F.relu(self.conv(x))))
        sigma = F.softplus(x) + self.min_sigma
        return resize_linear(sigma.permute(0, 2, 3, 1), (bh, bw), axes=(1, 2))


def uncert_nll_loss(depth: torch.Tensor, sigma: torch.Tensor,
                    gt: torch.Tensor, min_depth: float,
                    max_depth: float) -> torch.Tensor:
    """Gaussian NLL of the head's sigma over the valid ground truth
    (min_depth < gt < max_depth); ``depth`` is detached (head-only
    training)."""
    depth = depth.detach()
    valid = ((gt > min_depth) & (gt < max_depth)).to(depth.dtype)
    var = torch.clamp(sigma ** 2, min=1e-6)
    nll = 0.5 * (torch.log(var) + (gt - depth) ** 2 / var)
    return (nll * valid).sum() / (valid.sum() + 1e-7)
