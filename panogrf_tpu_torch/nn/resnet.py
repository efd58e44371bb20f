"""ResNet-18/34 and MobileNetV2 feature-pyramid encoders with torchvision
key names.

Port of ``panogrf_tpu/nn/resnet.py``.  ``ResNetEncoder``'s parameters
carry torchvision's names (``conv1``, ``bn1``,
``layer{i}.{j}.conv1/bn1/conv2/bn2/downsample.{0,1}``), the layout
``torch_convert.convert_resnet_encoder`` reads, so a released UniFuse
checkpoint loads as it is.  ``MobileNetV2Encoder``'s follow torchvision's
``mobilenet_v2`` ``features.{i}`` layout, which the reference's
``models/mobilenet.py`` keeps (the JAX package has no converter for it).
Every conv pads itself before a VALID conv: wrap padding (circular W, zero
H) for ERP encoders, zero padding for the cube and tangent-patch
encoders.  NCHW in, a list of 5 NCHW maps out; ``num_ch_enc`` gives their
channels.

BatchNorm (:class:`BatchNorm2d`, also used by ``nn/fusion.py``) follows
the JAX package rather than torch: in eval mode it normalises with the
running statistics; in training mode it normalises with the batch's mean
and biased variance and moves the running statistics towards them with
momentum 0.9 (eps 1e-5).  Torch's own ``nn.BatchNorm2d`` moves the running
variance towards the unbiased batch variance, which differs by n / (n - 1)
and would leave other running statistics after every training step.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.nn.blocks import BatchStatsMixin, PadConv2d


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
                 wrap: bool = True, in_channels: int = 3):
        super().__init__()
        self.conv1 = PadConv2d(in_channels, 64, 7, 2, bias=False, wrap=wrap)
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


class ConvBNReLU6(nn.Sequential):
    """conv (depthwise with ``depthwise``) -> BatchNorm -> ReLU6 = min(relu,
    6); torchvision keys ``0.weight``, ``1.*``."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 depthwise: bool = False, wrap: bool = True):
        super().__init__(PadConv2d(cin, cout, kernel, stride, bias=False,
                                   wrap=wrap,
                                   groups=cin if depthwise else 1),
                         batch_norm(cout), nn.ReLU6())


class InvertedResidual(nn.Module):
    """MobileNetV2 block: [1x1 expand] -> depthwise 3x3 -> 1x1 project ->
    BatchNorm, with the identity added at stride 1 and equal widths
    (torchvision keys ``conv.{i}``)."""

    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int,
                 wrap: bool = True):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        layers = [] if expand_ratio == 1 else [
            ConvBNReLU6(cin, hidden, 1, wrap=wrap)]
        layers += [ConvBNReLU6(hidden, hidden, 3, stride, depthwise=True,
                               wrap=wrap),
                   nn.Conv2d(hidden, cout, 1, bias=False), batch_norm(cout)]
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        return x + h if self.use_res else h


# (expand_ratio, channels, repeats, stride)
_MBV2_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                 (6, 64, 4, 2), (6, 96, 3, 1), (6, 160, 3, 2),
                 (6, 320, 1, 1))
# the maps tapped before these ``features`` indices, and after the last
_MBV2_TAPS = (2, 4, 7, 14)


class MobileNetV2Encoder(nn.Module):
    """MobileNetV2 feature pyramid with :class:`ResNetEncoder`'s interface:
    the maps after ``features`` [0:2], [2:4], [4:7], [7:14] and [14:18],
    channels (16, 24, 32, 96, 320) at strides (2, 4, 8, 16, 32).
    torchvision's last 1x1 conv (``features.18``) is never tapped and not
    built."""

    num_ch_enc = (16, 24, 32, 96, 320)

    def __init__(self, wrap: bool = True, in_channels: int = 3):
        super().__init__()
        feats = [ConvBNReLU6(in_channels, 32, 3, 2, wrap=wrap)]
        cin = 32
        for t, c, n, s in _MBV2_SETTING:
            for i in range(n):
                feats.append(InvertedResidual(cin, c, s if i == 0 else 1, t,
                                              wrap))
                cin = c
        self.features = nn.Sequential(*feats)

    def forward(self, x: torch.Tensor) -> list:
        out = []
        for i, block in enumerate(self.features):
            if i in _MBV2_TAPS:
                out.append(x)
            x = block(x)
        out.append(x)
        return out


def make_encoder(num_layers: int, wrap: bool = True,
                 in_channels: int = 3) -> nn.Module:
    """The encoder of ``num_layers``: 2 (MobileNetV2), 18 or 34 (ResNet)."""
    counts = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
    if num_layers == 2:
        return MobileNetV2Encoder(wrap, in_channels)
    if num_layers not in counts:
        raise ValueError(f"unsupported num_layers {num_layers} "
                         "(2 = MobileNetV2, 18, 34)")
    return ResNetEncoder(counts[num_layers], wrap, in_channels)


def resnet18(wrap: bool = True) -> ResNetEncoder:
    return ResNetEncoder((2, 2, 2, 2), wrap)


def resnet34(wrap: bool = True) -> ResNetEncoder:
    return ResNetEncoder((3, 4, 6, 3), wrap)
