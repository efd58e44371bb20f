"""ResNet-18/34 feature-pyramid encoders with torchvision key names.

Port of ``panogrf_tpu/nn/resnet.py`` (``ResNetEncoder``; the MobileNetV2
encoder is not ported yet).  Parameters carry torchvision's names
(``conv1``, ``bn1``, ``layer{i}.{j}.conv1/bn1/conv2/bn2/downsample.{0,1}``),
the layout ``torch_convert.convert_resnet_encoder`` reads, so a released
UniFuse checkpoint loads as it is.  Every conv pads itself before a VALID
conv: wrap padding (circular W, zero H) for ERP encoders, zero padding for
the cube encoder.  BatchNorm is torch's (eps 1e-5; the JAX package's
momentum 0.9 is torch's 0.1) and the depth stack runs it in eval mode.
NCHW in, a list of 5 NCHW maps out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.nn.blocks import PadConv2d


def batch_norm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ResNetBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1,
                 wrap: bool = True):
        super().__init__()
        self.conv1 = PadConv2d(cin, cout, 3, stride, bias=False, wrap=wrap)
        self.bn1 = batch_norm(cout)
        self.conv2 = PadConv2d(cout, cout, 3, bias=False, wrap=wrap)
        self.bn2 = batch_norm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                batch_norm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResNetEncoder(nn.Module):
    """ResNet feature pyramid: maps at strides [2, 4, 8, 16, 32] with
    channels [64, 64, 128, 256, 512]."""

    def __init__(self, block_counts: Sequence[int] = (2, 2, 2, 2),
                 wrap: bool = True):
        super().__init__()
        self.conv1 = PadConv2d(3, 64, 7, 2, bias=False, wrap=wrap)
        self.bn1 = batch_norm(64)
        cin = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 block_counts)):
            stride = 1 if i == 0 else 2
            layer = [ResNetBasicBlock(cin, planes, stride, wrap)]
            layer += [ResNetBasicBlock(planes, planes, 1, wrap)
                      for _ in range(1, blocks)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))
            cin = planes

    def forward(self, x: torch.Tensor) -> list:
        h = F.relu(self.bn1(self.conv1(x)))
        feats = [h]                                         # 1/2, 64
        # torchvision's max pool: k3 s2, padded with -inf
        h = F.max_pool2d(h, 3, 2, padding=1)
        for i in range(1, 5):
            h = getattr(self, f"layer{i}")(h)
            feats.append(h)
        return feats


def make_encoder(num_layers: int, wrap: bool = True) -> ResNetEncoder:
    """The encoder of ``num_layers`` (18 or 34)."""
    counts = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
    if num_layers == 2:
        raise NotImplementedError("the MobileNetV2 encoder is not ported to "
                                  "panogrf_tpu_torch yet")
    if num_layers not in counts:
        raise ValueError(f"unsupported num_layers {num_layers} (18, 34)")
    return ResNetEncoder(counts[num_layers], wrap)


def resnet18(wrap: bool = True) -> ResNetEncoder:
    return ResNetEncoder((2, 2, 2, 2), wrap)


def resnet34(wrap: bool = True) -> ResNetEncoder:
    return ResNetEncoder((3, 4, 6, 3), wrap)
