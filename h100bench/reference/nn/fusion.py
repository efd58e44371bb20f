"""The UniFuse cube->ERP fusion layer (CEE + SE).

Frozen from the port's ``nn/fusion.py``.  NCHW; the port's parameter
names (``res_conv1``, ``res_bn1``, ``selayer.fc.0``, ...).  The forward's
``train`` argument: None follows the module's mode, True or False sets
whether the BatchNorms use batch statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100bench.reference.nn.resnet import batch_norm


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


def make_fusion(kind: str, channels: int, se: bool = True) -> nn.Module:
    if kind != "cee":
        raise ValueError(f"unsupported fusion {kind!r} (cee)")
    return CEELayer(channels, use_se=se)
