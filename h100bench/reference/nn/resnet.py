"""The ResNet-18 feature-pyramid encoder with torchvision key names.

Frozen from the port's ``nn/resnet.py``.  ``ResNetEncoder``'s parameters
carry torchvision's names (``conv1``, ``bn1``,
``layer{i}.{j}.conv1/bn1/conv2/bn2/downsample.{0,1}``).  Every conv pads
itself before a VALID conv: wrap padding (circular W, zero H) for ERP
encoders, zero padding for the cube encoder.  NCHW in, a list of 5 NCHW
maps out; ``num_ch_enc`` gives their channels.

BatchNorm (:class:`BatchNorm2d`, also used by ``nn/fusion.py``) follows
the port rather than torch: in eval mode it normalises with the running
statistics; in training mode it normalises with the batch's mean and
biased variance and moves the running statistics towards them with
momentum 0.9 (eps 1e-5).  Torch's own ``nn.BatchNorm2d`` moves the running
variance towards the unbiased batch variance, which differs by n / (n - 1)
and would leave other running statistics after every training step.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from h100bench.reference.nn.blocks import BatchStatsMixin, PadConv2d


class BatchNorm2d(BatchStatsMixin, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (same parameters and buffers, so reference
    checkpoints load) whose training-mode update of the running statistics
    uses the biased batch variance: running = 0.9 running + 0.1 batch
    (``nn/blocks.BatchStatsMixin``)."""


def batch_norm(channels: int) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1)


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

    num_ch_enc = (64, 64, 128, 256, 512)

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


def make_encoder(num_layers: int, wrap: bool = True) -> nn.Module:
    """The ResNet encoder of ``num_layers`` (18, the shipped nets')."""
    if num_layers != 18:
        raise ValueError(f"unsupported num_layers {num_layers} (18)")
    return ResNetEncoder((2, 2, 2, 2), wrap)
