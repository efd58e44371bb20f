"""Ray-feature initialization net and visibility encoder.

Frozen from the port's ``renderer/init_net.py`` with the ``ResUNetLight``
image encoder (``feature_type`` "ERP").  The frozen depth stack is not a
submodule: callers pass ``mvs_depth`` in.  Inputs and outputs are
channel-last.
"""

from __future__ import annotations

import torch
from torch import nn

from h100bench.reference.nn.blocks import (ResUNetLight, ResidualBlock,
                                         WrapConv, resize_linear)


def normalize_inverse_depth(depth: torch.Tensor, min_depth: float,
                            max_depth: float) -> torch.Tensor:
    """Depth -> clamped normalized inverse depth."""
    near_inv = -1.0 / min_depth
    far_inv = -1.0 / max_depth
    d = -1.0 / torch.clamp(depth, min=1e-5)
    d = (d - near_inv) / (far_inv - near_inv)
    return torch.clamp(d, 0.0, 1.0)


class _ConvResConv(nn.Sequential):
    """conv3x3 -> ResidualBlock(s) -> conv1x1 head (NCHW)."""

    def __init__(self, cin: int, features: int, num_res: int = 1):
        super().__init__(
            WrapConv(cin, features, 3, bias=False),
            *[ResidualBlock(features) for _ in range(num_res)],
            nn.Conv2d(features, features, 1, bias=False))


def _nhwc(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return module(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class CostVolumeInitNet(nn.Module):
    """(ref imgs, mvs depth) -> ray features at 1/4 of ``depth_hw``."""

    def __init__(self, depth_hw: tuple = (256, 512), min_depth: float = 0.1,
                 max_depth: float = 10.0, feat_dim: int = 32):
        super().__init__()
        self.depth_hw = tuple(depth_hw)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.res_net = ResUNetLight(feat_dim, (2, 3, 6), 32)
        self.depth_conv = _ConvResConv(1, 32)
        self.out_conv = _ConvResConv(feat_dim + 32, feat_dim)

    def forward(self, imgs: torch.Tensor,
                mvs_depth: torch.Tensor) -> torch.Tensor:
        """imgs (rfn, H, W, 3), mvs_depth (rfn, dh, dw, 1) ->
        (rfn, dh/4, dw/4, feat_dim)."""
        dh, dw = self.depth_hw
        ref_feats = self.res_net(resize_linear(imgs, (dh, dw), axes=(1, 2)))
        depth = normalize_inverse_depth(mvs_depth, self.min_depth,
                                        self.max_depth)
        if depth.shape[1] != dh or depth.shape[2] != dw:
            depth = resize_linear(depth, (dh, dw), axes=(1, 2))
        depth = resize_linear(depth, (dh // 4, dw // 4), axes=(1, 2))
        depth_feats = _nhwc(self.depth_conv, depth)
        return _nhwc(self.out_conv, torch.cat([ref_feats, depth_feats], -1))


class DefaultVisEncoder(nn.Module):
    """[img feats | init ray feats] -> refined ray feats."""

    def __init__(self, feat_dim: int = 32):
        super().__init__()
        self.out_conv = _ConvResConv(32 + feat_dim, 32, num_res=2)

    def forward(self, ray_feats: torch.Tensor,
                img_feats: torch.Tensor) -> torch.Tensor:
        if img_feats.shape[1:3] != ray_feats.shape[1:3]:
            img_feats = resize_linear(
                img_feats, (ray_feats.shape[1], ray_feats.shape[2]),
                axes=(1, 2))
        return _nhwc(self.out_conv, torch.cat([img_feats, ray_feats], -1))
