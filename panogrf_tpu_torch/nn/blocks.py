"""ERP-aware conv blocks of the renderer's encoders and the depth stack.

Port of ``panogrf_tpu/nn/blocks.py``.  Modules run in NCHW (NCDHW in
3D) inside and are named after the reference PyTorch layout that
``panogrf_tpu/utils/torch_convert`` reads: in the renderer a wrap-padded
3x3 conv is ``Sequential(WrapPad, Conv2d)`` (keys ``<name>.1.weight``);
in the depth stack it is a conv that pads itself (``PadConv2d``,
``WrapConv3D``: keys ``<name>.weight``).  ``wrap=False`` pads with zeros
in W too (tangent patches, cube faces).  The BatchNorms of the depth nets
(``BatchStatsMixin``) follow the JAX package's running-statistics rule.
``resize_linear``, ``wrap_pad_2d``, ``upsample2x_nearest`` and
``ResUNetLight`` take and return channel-last tensors, as their JAX
counterparts do.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.parallel.mesh import Mesh, pmean


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


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: LeCun-normal weights, unit norm scales and
    zero biases (the JAX package's initialisers, untruncated)."""
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator)
                    / fan_in ** 0.5)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()


class BatchStatsMixin:
    """The forward of the port's BatchNorms (``nn/resnet.BatchNorm2d``,
    :class:`BatchNorm3d`), as the JAX package's: in eval mode it
    normalises with the running statistics; in training mode with the
    batch's mean and biased variance, moving the running statistics
    towards them with momentum 0.9 (eps 1e-5).  Torch's own BatchNorm
    moves the running variance towards the unbiased batch variance, which
    differs by n / (n - 1).  ``train`` overrides the module's mode, as the
    JAX modules' explicit ``train`` argument does.

    With ``bn_axis`` set (:func:`set_bn_axis`, which also hands over the
    mesh) training takes the JAX package's cross-replica statistics (its
    ``BatchNorm(axis_name=...)``): the means of x and of x squared are
    averaged over the axis's ranks, with their gradients, and the variance
    is their difference ``mean(x^2) - mean(x)^2``."""

    bn_axis: str | None = None
    bn_mesh: Mesh | None = None

    def forward(self, x: torch.Tensor,
                train: bool | None = None) -> torch.Tensor:
        if not (self.training if train is None else train):
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        dims = (0, *range(2, x.dim()))
        if self.bn_axis is not None:
            return self._synced(x, dims)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=dims, unbiased=False)
            self._track(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    def _track(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)

    def _synced(self, x: torch.Tensor, dims: tuple) -> torch.Tensor:
        mean, mean2 = pmean(torch.stack([x.mean(dims), (x * x).mean(dims)]),
                            self.bn_mesh, self.bn_axis)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        self._track(mean.detach(), var.detach())
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


def set_bn_axis(module: nn.Module, axis: str | None,
                mesh: Mesh | None = None) -> nn.Module:
    """Give every BatchNorm of ``module`` the cross-replica axis ``axis`` of
    ``mesh`` (``axis`` None: the local batch), the role of the JAX modules'
    ``bn_axis`` argument; returns ``module``."""
    if axis is not None and mesh is None:
        raise ValueError(f"bn_axis={axis!r} needs the mesh whose axis it is")
    for m in module.modules():
        if isinstance(m, BatchStatsMixin):
            m.bn_axis, m.bn_mesh = axis, (mesh if axis is not None else None)
    return module


class BatchNorm3d(BatchStatsMixin, nn.BatchNorm3d):
    """``nn.BatchNorm3d`` with the JAX package's statistics rule."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)


class WrapPad(nn.Module):
    """Zero pad in H, circular pad in W (zero without ``wrap``); NCHW."""

    def __init__(self, pad: int, wrap: bool = True):
        super().__init__()
        self.pad = pad
        self.wrap = wrap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.wrap:
            return F.pad(x, (self.pad,) * 4)
        return _wrap_pad_nchw(x, self.pad, self.pad)


class WrapConv(nn.Sequential):
    """Wrap padding + VALID conv (reference keys ``.1.weight``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, bias: bool = True, wrap: bool = True):
        super().__init__(WrapPad((kernel_size - 1) // 2, wrap),
                         nn.Conv2d(cin, cout, kernel_size, stride,
                                   bias=bias))


class InstanceNorm(nn.InstanceNorm2d):
    """Per-channel spatial normalization with affine params (the JAX
    package's ``GroupNorm(group_size=1)``)."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, affine=True)


class ConvINELU(nn.Module):
    """conv -> instance norm -> ELU (reference module ``conv``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 wrap: bool = True):
        super().__init__()
        self.conv = WrapConv(cin, cout, kernel_size, bias=True, wrap=wrap)
        self.bn = InstanceNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.bn(self.conv(x)))


class UpconvINELU(nn.Module):
    """2x bilinear upsample (align corners) + ConvINELU."""

    def __init__(self, cin: int, cout: int, wrap: bool = True):
        super().__init__()
        self.conv = ConvINELU(cin, cout, wrap=wrap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample2x_bilinear(x, True, axes=(2, 3)))


class ResidualBlock(nn.Module):
    """Pre-activation residual block, norm-relu-conv3x3 twice (reference
    Sequential indices: IN 0, conv 3, IN 4, conv 7)."""

    def __init__(self, channels: int, wrap: bool = True):
        super().__init__()
        c = channels
        self.conv = nn.Sequential(
            InstanceNorm(c), nn.ReLU(), WrapPad(1, wrap),
            nn.Conv2d(c, c, 3, bias=False),
            InstanceNorm(c), nn.ReLU(), WrapPad(1, wrap),
            nn.Conv2d(c, c, 3, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x)


class BasicBlock(nn.Module):
    """ResNet basic block with instance norm."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 wrap: bool = True):
        super().__init__()
        self.conv1 = WrapConv(cin, cout, 3, stride, bias=False, wrap=wrap)
        self.bn1 = InstanceNorm(cout)
        self.conv2 = WrapConv(cout, cout, 3, bias=False, wrap=wrap)
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


# ---------------------------------------------------------------------------
# depth-stack blocks (UniFuse / MVS)
# ---------------------------------------------------------------------------

def wrap_pad_3d(x: torch.Tensor, pad_d: int, pad_h: int,
                pad_w: int) -> torch.Tensor:
    """Zero-pad depth and latitude, circular-pad longitude; NCDHW."""
    if pad_d or pad_h:
        x = F.pad(x, (0, 0, pad_h, pad_h, pad_d, pad_d))
    if pad_w:
        x = torch.cat([x[..., -pad_w:], x, x[..., :pad_w]], dim=-1)
    return x


def upsample2x_nearest(x: torch.Tensor, axes: Sequence[int] = (1, 2)
                       ) -> torch.Tensor:
    """Nearest 2x upsample of the spatial ``axes`` (NHWC default)."""
    for axis in axes:
        x = torch.repeat_interleave(x, 2, dim=axis)
    return x


class PadConv2d(nn.Conv2d):
    """VALID conv after an explicit pad of ``padding`` ((k-1)//2 by
    default): wrap (circular W, zero H) or zero; NCHW.  Its parameters are
    the plain ``weight``/``bias`` of the reference's converted convs."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, bias: bool = True, wrap: bool = True,
                 padding: int | None = None, groups: int = 1):
        super().__init__(cin, cout, kernel_size, stride, bias=bias,
                         groups=groups)
        self.pad = (kernel_size - 1) // 2 if padding is None else padding
        self.wrap = wrap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pad
        if p:
            x = _wrap_pad_nchw(x, p, p) if self.wrap else F.pad(x, (p,) * 4)
        return super().forward(x)


class WrapConv3D(nn.Conv3d):
    """3D conv over (D, H, W) with zero padding in D, H and circular
    padding in W (or zero everywhere without ``wrap``); NCDHW."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, bias: bool = True, wrap: bool = True):
        super().__init__(cin, cout, kernel_size, stride, bias=bias)
        self.pad = (kernel_size - 1) // 2
        self.wrap = wrap

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pad
        if p:
            x = wrap_pad_3d(x, p, p, p) if self.wrap else F.pad(x, (p,) * 6)
        return super().forward(x)


class ConvBlock2(nn.Module):
    """[2x bilinear upscale (align_corners=False)] -> conv-lrelu-conv-lrelu
    [-> 2x2 average pool]; NCHW.  Returns (pooled, unpooled) like the
    reference."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 wrap: bool = True, use_activation: bool = True,
                 upscale: bool = False, pool: bool = True):
        super().__init__()
        self.conv1 = PadConv2d(cin, cout, kernel_size, wrap=wrap)
        self.conv2 = PadConv2d(cout, cout, kernel_size, wrap=wrap)
        self.use_activation = use_activation
        self.upscale = upscale
        self.pool = pool

    def forward(self, x: torch.Tensor) -> tuple:
        if self.upscale:
            x = upsample2x_bilinear(x, False, axes=(2, 3))
        act = (lambda t: F.leaky_relu(t, 0.01)) if self.use_activation \
            else (lambda t: t)
        h = act(self.conv2(act(self.conv1(x))))
        return (F.avg_pool2d(h, 2) if self.pool else h), h


class Conv3DBlock(nn.Module):
    """conv3d-lrelu-conv3d-lrelu [-> 2x2x2 average pool]; NCDHW."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 wrap: bool = True, pool: bool = True):
        super().__init__()
        self.conv1 = WrapConv3D(cin, cout, kernel_size, wrap=wrap)
        self.conv2 = WrapConv3D(cout, cout, kernel_size, wrap=wrap)
        self.pool = pool

    def forward(self, x: torch.Tensor) -> tuple:
        h = F.leaky_relu(self.conv1(x), 0.01)
        h = F.leaky_relu(self.conv2(h), 0.01)
        return (F.avg_pool3d(h, 2) if self.pool else h), h


class UNet3D(nn.Module):
    """3D UNet cost regularizer (the reference's ``UNet2`` over
    ``Conv3DBlockv2``): ``num_layers`` pooled encoder levels with channels
    base*2^(i+1), an unpooled bottleneck, trilinear upsampling and skip
    concatenation; NCDHW.

    As in the reference, the first decoder takes no skip and the deepest
    encoder skip is never read.  ``decoders[j]`` is the decoder that
    returns to level j, so the forward runs ``decoders[n-1]`` first and
    ``decoders[0]`` (to ``out_features``) last.
    """

    def __init__(self, in_features: int, base_features: int = 32,
                 num_layers: int = 3, out_features: int = 1,
                 wrap: bool = True):
        super().__init__()
        n, b = num_layers, base_features
        enc = [b * 2 ** (i + 1) for i in range(n + 1)]
        self.encoders = nn.ModuleList(
            Conv3DBlock(cin, cout, wrap=wrap, pool=i < n)
            for i, (cin, cout) in enumerate(zip([in_features] + enc, enc)))
        dec = []
        for j in range(n):
            cout = b * 2 ** j if j > 0 else out_features
            cin = enc[n] if j == n - 1 else b * 2 ** (j + 1) + enc[j]
            dec.append(Conv3DBlock(cin, cout, wrap=wrap, pool=False))
        self.decoders = nn.ModuleList(dec)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        h = x
        for block in self.encoders[:-1]:
            h, unpooled = block(h)
            skips.append(unpooled)
        _, h = self.encoders[-1](h)

        def up(t, target):
            return resize_linear(t, target.shape[2:], axes=(2, 3, 4))

        n = len(self.decoders)
        _, h = self.decoders[n - 1](up(h, skips[-1]))
        for i in range(n - 2, -1, -1):
            h = torch.cat([up(h, skips[i]), skips[i]], 1)
            _, h = self.decoders[i](h)
        return h


class ConvBnLReLU3D(nn.Module):
    """Wrap-padded 3x3x3 conv (no bias) -> BatchNorm3d -> leaky ReLU 0.01;
    NCDHW (reference keys ``conv.weight``, ``bn.*``)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 wrap: bool = True):
        super().__init__()
        self.conv = WrapConv3D(cin, cout, 3, stride, bias=False, wrap=wrap)
        self.bn = BatchNorm3d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.bn(self.conv(x)), 0.01)


class UpConvBn3D(ConvBnLReLU3D):
    """Trilinear resize (align_corners=False) to the skip's (D, H, W), then
    :class:`ConvBnLReLU3D` (the JAX package's form, not a transposed
    conv)."""

    def forward(self, x: torch.Tensor, size) -> torch.Tensor:
        return super().forward(resize_linear(x, tuple(size), axes=(2, 3, 4)))


class CostRegNet(nn.Module):
    """MVSNet-style 3D cost regulariser, the ``use_new_reg3dnet``
    alternative to :class:`UNet3D`: an 8 -> 16 -> 32 -> 64 strided encoder,
    a decoder of resizes and convs with additive skips, and a 1-channel
    head; NCDHW in, (B, 1, D, H, W) out.  Keys follow
    ``torch_convert.convert_cost_reg`` (``conv{0..7,9,11}.conv.weight``,
    ``.bn.*``, ``prob.conv.weight``)."""

    def __init__(self, in_channels: int, wrap: bool = True):
        super().__init__()
        chans = ((in_channels, 8, 1), (8, 16, 2), (16, 16, 1), (16, 32, 2),
                 (32, 32, 1), (32, 64, 2), (64, 64, 1))
        for i, (cin, cout, stride) in enumerate(chans):
            self.add_module(f"conv{i}", ConvBnLReLU3D(cin, cout, stride,
                                                      wrap))
        self.conv7 = UpConvBn3D(64, 32, wrap=wrap)
        self.conv9 = UpConvBn3D(32, 16, wrap=wrap)
        self.conv11 = UpConvBn3D(16, 8, wrap=wrap)
        self.prob = nn.Module()
        self.prob.conv = WrapConv3D(8, 1, 3, bias=False, wrap=wrap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv0 = self.conv0(x)
        conv2 = self.conv2(self.conv1(conv0))
        conv4 = self.conv4(self.conv3(conv2))
        h = self.conv6(self.conv5(conv4))
        h = conv4 + self.conv7(h, conv4.shape[2:])
        h = conv2 + self.conv9(h, conv2.shape[2:])
        h = conv0 + self.conv11(h, conv0.shape[2:])
        return self.prob.conv(h)
