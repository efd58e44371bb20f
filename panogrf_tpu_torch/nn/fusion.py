"""Cube->ERP feature fusion layers (Concat / BiProj / CEE + SE).

Port of ``panogrf_tpu/nn/fusion.py``.  NCHW; parameter names follow the
reference layout that ``torch_convert._convert_cee`` and
``convert_unifuse`` read (``res_conv1``, ``res_bn1``, ``selayer.fc.0``,
``conv_e2c.0``, ...).  Each layer's forward takes the JAX package's
``train`` argument: None follows the module's mode, True or False sets
whether the CEE layer's BatchNorms use batch statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.nn.resnet import batch_norm


class Concat(nn.Module):
    """cat -> 1x1 conv -> relu."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(2 * channels, channels, 1, bias=False)

    def forward(self, equi_feat, c2e_feat, train=None):
        return F.relu(self.conv(torch.cat([equi_feat, c2e_feat], 1)))


class BiProj(nn.Module):
    """BiFuse-style gated addition."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv_e2c = nn.Sequential(nn.Conv2d(c, c, 3, padding=1),
                                      nn.ReLU())
        self.conv_c2e = nn.Sequential(nn.Conv2d(c, c, 3, padding=1),
                                      nn.ReLU())
        self.conv_mask = nn.Sequential(nn.Conv2d(2 * c, 1, 1), nn.Sigmoid())

    def forward(self, equi_feat, c2e_feat, train=None):
        e = self.conv_e2c(equi_feat)
        c = self.conv_c2e(c2e_feat)
        return equi_feat + c * self.conv_mask(torch.cat([e, c], 1))


class SELayer(nn.Module):
    """Squeeze-excitation."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(torch.mean(x, (2, 3)))[:, :, None, None]


class CEELayer(nn.Module):
    """Cube-ERP enhancement fusion."""

    def __init__(self, channels: int, use_se: bool = True):
        super().__init__()
        c = channels
        self.res_conv1 = nn.Conv2d(2 * c, c, 1, bias=False)
        self.res_bn1 = batch_norm(c)
        self.res_conv2 = nn.Conv2d(c, c, 3, padding=1, bias=False)
        self.res_bn2 = batch_norm(c)
        self.selayer = SELayer(2 * c) if use_se else None
        self.conv = nn.Conv2d(2 * c, c, 1, bias=False)

    def forward(self, equi_feat, c2e_feat, train=None):
        x = torch.cat([equi_feat, c2e_feat], 1)
        x = F.relu(self.res_bn1(self.res_conv1(x), train))
        shortcut = self.res_bn2(self.res_conv2(x), train)
        x = torch.cat([equi_feat, c2e_feat + shortcut], 1)
        if self.selayer is not None:
            x = self.selayer(x)
        return F.relu(self.conv(x))


FUSION_LAYERS = {"cat": Concat, "biproj": BiProj, "cee": CEELayer}


def make_fusion(kind: str, channels: int, se: bool = True) -> nn.Module:
    if kind == "cee":
        return CEELayer(channels, use_se=se)
    return FUSION_LAYERS[kind](channels)
