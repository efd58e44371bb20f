"""Dual-branch ERP + tangent-patch encoders, and the patch-only and
cube-only encoders.

Port of ``panogrf_tpu/nn/erp_tp.py``: ``ERPTPEncoder`` (the renderer's
``ERP+TP`` image and init-net encoder and the MVS ``ERP+TP`` feature net),
``TPOnlyEncoder``, ``CubeOnlyEncoder`` and the ``ENCODERS`` registry.  The
tangent branch folds the N gnomonic patches into the batch axis, shares
its conv weights across patches and is resampled back to ERP at each
level for fusion (:mod:`panogrf_tpu_torch.core.tangent`).  Channel-last in
and out, NCHW inside.

The fusion layers' BatchNorms take an explicit ``train`` argument, as in
the JAX package, rather than the module's mode: ``forward(x, train=False)``
normalises them with their running statistics even under ``.train()``
(the renderer calls its encoders so), and the MVS feature net passes its
own mode.  The JAX package has no reference converter for these
encoders; parameter names are the port's own, after ``ResUNetLight``'s:
``conv1``/``bn1``/``layer{1,2,3}`` (ERP branch), ``tp_conv1``/``tp_bn1``/
``tp_layer{1,2,3}`` (tangent branch), ``fusion{1,2,3}``, ``upconv3``,
``iconv3``, ``upconv2``, ``iconv2``, ``out_conv``; the single-branch
encoders have ``layer.{0,1,2}``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.core import cubemap, tangent
from panogrf_tpu_torch.nn.blocks import (BasicBlock, ConvINELU, InstanceNorm,
                                         UpconvINELU, WrapPad)
from panogrf_tpu_torch.nn.fusion import make_fusion


def _stage(cin: int, planes: int, blocks: int, wrap: bool) -> nn.Sequential:
    return nn.Sequential(
        BasicBlock(cin, planes, 2, wrap),
        *[BasicBlock(planes, planes, 1, wrap) for _ in range(1, blocks)])


def _to_patches(x: torch.Tensor, nrows: int, ps: int,
                fov: float) -> torch.Tensor:
    """ERP (B, H, W, C) -> the patches folded into the batch, NCHW
    (B*N, C, ps, ps)."""
    p = tangent.equi_to_tangent(x, nrows, (ps, ps), (fov, fov))
    return p.reshape(-1, ps, ps, x.shape[-1]).permute(0, 3, 1, 2)


def _patches_to_erp(t: torch.Tensor, b: int, eh: int, ew: int, nrows: int,
                    fov: float) -> torch.Tensor:
    """Patch features (B*N, C, f, f) -> ERP NCHW (B, C, eh, ew)."""
    c, f = t.shape[1], t.shape[2]
    grouped = t.permute(0, 2, 3, 1).reshape(b, -1, f, f, c)
    return tangent.tangent_to_equi(grouped, (eh, ew), nrows,
                                   (fov, fov)).permute(0, 3, 1, 2)


class ERPTPEncoder(nn.Module):
    """ERP + tangent-patch ResUNet: (B, H, W, C) -> (B, H/4, W/4, out_dim).

    An alternative to ``ResUNetLight``: stride-2 stages of ``layers``
    BasicBlocks (planes 32/64/128) on the ERP image and, with zero
    padding, on its N patches; after each stage the patch features are
    resampled to ERP and fused into the ERP branch (``fusion_type``).
    """

    def __init__(self, out_dim: int = 32, layers: Sequence[int] = (1, 2, 6),
                 inplanes: int = 16, nrows: int = 4, patch_size: int = 64,
                 fov: float = 80.0, fusion_type: str = "cee",
                 se_in_fusion: bool = True, wrap: bool = True,
                 in_channels: int = 3):
        super().__init__()
        self.nrows, self.patch_size, self.fov = nrows, patch_size, fov
        self.conv1 = nn.Sequential(WrapPad(3, wrap), nn.Conv2d(
            in_channels, inplanes, 7, 2, bias=False))
        self.bn1 = InstanceNorm(inplanes)
        self.tp_conv1 = nn.Sequential(WrapPad(3, False), nn.Conv2d(
            in_channels, inplanes, 7, 2, bias=False))
        self.tp_bn1 = InstanceNorm(inplanes)
        cin = inplanes
        for i, (planes, blocks) in enumerate(zip((32, 64, 128), layers), 1):
            self.add_module(f"layer{i}", _stage(cin, planes, blocks, wrap))
            self.add_module(f"tp_layer{i}", _stage(cin, planes, blocks,
                                                   False))
            self.add_module(f"fusion{i}", make_fusion(fusion_type, planes,
                                                      se_in_fusion))
            cin = planes
        self.upconv3 = UpconvINELU(128, 64, wrap)
        self.iconv3 = ConvINELU(128, 64, wrap=wrap)
        self.upconv2 = UpconvINELU(64, 32, wrap)
        self.iconv2 = ConvINELU(64, 32, wrap=wrap)
        self.out_conv = nn.Conv2d(32, out_dim, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b = x.shape[0]
        e = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        t = F.relu(self.tp_bn1(self.tp_conv1(_to_patches(
            x, self.nrows, self.patch_size, self.fov))))
        feats = []
        for i in (1, 2, 3):
            e = getattr(self, f"layer{i}")(e)
            t = getattr(self, f"tp_layer{i}")(t)
            t_erp = _patches_to_erp(t, b, e.shape[2], e.shape[3], self.nrows,
                                    self.fov)
            e = getattr(self, f"fusion{i}")(e, t_erp, train)
            feats.append(e)
        x1, x2, x3 = feats
        h = self.iconv3(torch.cat([x2, self.upconv3(x3)], 1))
        h = self.iconv2(torch.cat([x1, self.upconv2(h)], 1))
        return self.out_conv(h).permute(0, 2, 3, 1)


def _single_branch(out_dim: int) -> nn.Sequential:
    return nn.Sequential(BasicBlock(3, 32, 2, False),
                         BasicBlock(32, 32, 2, False),
                         BasicBlock(32, out_dim, 1, False))


class TPOnlyEncoder(nn.Module):
    """Tangent-patch-only encoder: three BasicBlocks on the patches (two of
    stride 2), resampled to ERP at 1/4 resolution."""

    def __init__(self, out_dim: int = 32, nrows: int = 4,
                 patch_size: int = 64, fov: float = 80.0):
        super().__init__()
        self.nrows, self.patch_size, self.fov = nrows, patch_size, fov
        self.layer = _single_branch(out_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, h, w, _ = x.shape
        t = self.layer(_to_patches(x, self.nrows, self.patch_size, self.fov))
        return _patches_to_erp(t, b, h // 4, w // 4, self.nrows,
                               self.fov).permute(0, 2, 3, 1)


class CubeOnlyEncoder(nn.Module):
    """Cubemap-only encoder: three BasicBlocks on the H/2 faces, resampled
    to ERP at 1/4 resolution."""

    def __init__(self, out_dim: int = 32):
        super().__init__()
        self.layer = _single_branch(out_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, h, w, c = x.shape
        fw = h // 2
        cube = cubemap.equi_to_cube(x, fw).reshape(b * 6, fw, fw, c)
        t = self.layer(cube.permute(0, 3, 1, 2))
        f = t.shape[2]
        grouped = t.permute(0, 2, 3, 1).reshape(b, 6, f, f, -1)
        return cubemap.cube_to_equi(grouped, h // 4, w // 4)


ENCODERS = {"ERP+TP": ERPTPEncoder, "TP": TPOnlyEncoder,
            "Cube": CubeOnlyEncoder}
