"""ERP-aware conv blocks of the renderer's encoders.

Port of the renderer half of ``panogrf_tpu/nn/blocks.py``.  Modules run in
NCHW inside and are named after the reference PyTorch layout that
``panogrf_tpu/utils/torch_convert.convert_renderer`` reads: a wrap-padded
3x3 conv is ``Sequential(WrapPad, Conv2d)`` (keys ``<name>.1.weight``).
``resize_linear``, ``wrap_pad_2d`` and ``ResUNetLight`` take and return
channel-last tensors, as their JAX counterparts do.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def _wrap_pad_nchw(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    if pad_h:
        x = F.pad(x, (0, 0, pad_h, pad_h))
    if pad_w:
        x = torch.cat([x[..., -pad_w:], x, x[..., :pad_w]], dim=-1)
    return x


def wrap_pad_2d(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Zero-pad latitude (H), circular-pad longitude (W); NHWC.
    (``F.pad(mode='circular')`` would wrap both axes.)"""
    return _wrap_pad_nchw(x.permute(0, 3, 1, 2), pad_h, pad_w) \
        .permute(0, 2, 3, 1)


def _axis_linear_weights(n_in: int, n_out: int, align_corners: bool,
                         device) -> tuple:
    idx = torch.arange(n_out, dtype=torch.float32, device=device)
    if align_corners and n_out > 1:
        src = idx * (n_in - 1) / (n_out - 1)
    else:
        src = torch.clamp((idx + 0.5) * (n_in / n_out) - 0.5,
                          0.0, n_in - 1.0)
    i0 = torch.clamp(torch.floor(src).long(), 0, n_in - 1)
    i1 = torch.clamp(i0 + 1, 0, n_in - 1)
    return i0, i1, src - i0.float()


def resize_linear(x: torch.Tensor, out_sizes: Sequence[int], *,
                  axes: Sequence[int],
                  align_corners: bool = False) -> torch.Tensor:
    """Separable linear resize with the JAX package's align-corners and
    clamp rules (``panogrf_tpu/nn/blocks.py:67-98``).  The float32 blend
    weights promote a bfloat16 ``x`` to float32, as in JAX."""
    for axis, n_out in zip(axes, out_sizes):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        i0, i1, t = _axis_linear_weights(n_in, n_out, align_corners,
                                         x.device)
        shape = [1] * x.dim()
        shape[axis] = n_out
        t = t.reshape(shape)
        x = x.index_select(axis, i0) * (1 - t) + x.index_select(axis, i1) * t
    return x


def upsample2x_bilinear(x: torch.Tensor, align_corners: bool = True,
                        axes: Sequence[int] = (1, 2)) -> torch.Tensor:
    """2x bilinear upsample of the two spatial ``axes`` (NHWC default)."""
    return resize_linear(x, [2 * x.shape[a] for a in axes], axes=axes,
                         align_corners=align_corners)


class WrapPad(nn.Module):
    """Zero pad in H, circular pad in W (NCHW)."""

    def __init__(self, pad: int):
        super().__init__()
        self.pad = pad

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _wrap_pad_nchw(x, self.pad, self.pad)


class WrapConv(nn.Sequential):
    """Wrap padding + VALID conv (reference keys ``.1.weight``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, bias: bool = True):
        super().__init__(WrapPad((kernel_size - 1) // 2),
                         nn.Conv2d(cin, cout, kernel_size, stride,
                                   bias=bias))


class InstanceNorm(nn.InstanceNorm2d):
    """Per-channel spatial normalization with affine params (the JAX
    package's ``GroupNorm(group_size=1)``)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, affine=True)


class ConvINELU(nn.Module):
    """conv -> instance norm -> ELU (reference module ``conv``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3):
        super().__init__()
        self.conv = WrapConv(cin, cout, kernel_size, bias=True)
        self.bn = InstanceNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.bn(self.conv(x)))


class UpconvINELU(nn.Module):
    """2x bilinear upsample (align corners) + ConvINELU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = ConvINELU(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2x_bilinear(x, True, axes=(2, 3)))


class ResidualBlock(nn.Module):
    """Pre-activation residual block, norm-relu-conv3x3 twice (reference
    Sequential indices: IN 0, conv 3, IN 4, conv 7)."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.conv = nn.Sequential(
            InstanceNorm(c), nn.ReLU(), WrapPad(1),
            nn.Conv2d(c, c, 3, bias=False),
            InstanceNorm(c), nn.ReLU(), WrapPad(1),
            nn.Conv2d(c, c, 3, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x)


class BasicBlock(nn.Module):
    """ResNet basic block with instance norm."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = WrapConv(cin, cout, 3, stride, bias=False)
        self.bn1 = InstanceNorm(cout)
        self.conv2 = WrapConv(cout, cout, 3, bias=False)
        self.bn2 = InstanceNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                InstanceNorm(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(h + identity)


class ResUNetLight(nn.Module):
    """2D ResUNet image encoder: (N, H, W, 3) -> (N, H/4, W/4, out_dim).

    ``layers`` gives the BasicBlock counts of the three stride-2 stages
    (planes 32/64/128).
    """

    def __init__(self, out_dim: int = 32, layers: Sequence[int] = (2, 3, 6),
                 inplanes: int = 32):
        super().__init__()
        self.conv1 = nn.Sequential(WrapPad(3),
                                   nn.Conv2d(3, inplanes, 7, 2, bias=False))
        self.bn1 = InstanceNorm(inplanes)

        def stage(cin, planes, blocks):
            return nn.Sequential(
                BasicBlock(cin, planes, 2),
                *[BasicBlock(planes, planes) for _ in range(1, blocks)])

        self.layer1 = stage(inplanes, 32, layers[0])
        self.layer2 = stage(32, 64, layers[1])
        self.layer3 = stage(64, 128, layers[2])
        self.upconv3 = UpconvINELU(128, 64)
        self.iconv3 = ConvINELU(128, 64)
        self.upconv2 = UpconvINELU(64, 32)
        self.iconv2 = ConvINELU(64, 32)
        self.out_conv = nn.Conv2d(32, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % 16 or x.shape[2] % 16:
            raise ValueError(f"ResUNetLight needs H, W divisible by 16, "
                             f"got {x.shape[1]}x{x.shape[2]}")
        x0 = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x1 = self.layer1(x0)                                  # 1/4
        x2 = self.layer2(x1)                                  # 1/8
        x3 = self.layer3(x2)                                  # 1/16
        h = self.iconv3(torch.cat([x2, self.upconv3(x3)], 1))
        h = self.iconv2(torch.cat([x1, self.upconv2(h)], 1))
        return self.out_conv(h).permute(0, 2, 3, 1)
