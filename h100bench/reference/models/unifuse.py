"""The UniFuse 360-degree mono-depth network and the Equi feature network.

Frozen from the port's ``models/unifuse.py`` at the shipped
configuration:

* ``UniFuse``: a ResNet-18 ERP encoder and a ResNet-18 cubemap encoder
  (the 6 faces folded into the batch), per-level cube->ERP resampling
  fused into the ERP decoder, a sigmoid depth head;
* ``Equi``: the ERP-only encoder/decoder that gives the MVS net its
  32-channel features at 1/4 resolution.

Parameter names are the port's: encoders under ``equi_encoder`` /
``cube_encoder`` and the decoder as one flat ModuleList
``equi_decoder.{i}`` in the reference's registration order.  Inputs and
outputs are channel-last; the convs run NCHW.  Training mode is the
modules' ``train()``: BatchNorm then uses and updates batch statistics
(``nn/resnet.BatchNorm2d``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from h100bench.reference.core import cubemap
from h100bench.reference.nn.blocks import PadConv2d, upsample2x_nearest
from h100bench.reference.nn.fusion import make_fusion
from h100bench.reference.nn.resnet import make_encoder

# torchvision-resnet18 encoder channels / decoder channels
NUM_CH_DEC = (16, 32, 64, 128, 256)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# decoder ModuleList order of the reference UniFuse and of Equi
UNIFUSE_DECODER_ORDER = (
    "fusion_5", "upconv_5", "fusion_4", "deconv_4", "upconv_4",
    "fusion_3", "deconv_3", "upconv_3", "fusion_2", "deconv_2", "upconv_2",
    "fusion_1", "deconv_1", "upconv_1", "deconv_0", "depthconv_0")
EQUI_DECODER_ORDER = ("upconv_5", "deconv_4", "upconv_4", "deconv_3",
                      "upconv_3", "deconv_2", "upconv_2")


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalisation of channel-last RGB in [0, 1]."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def _up(x: torch.Tensor) -> torch.Tensor:
    return upsample2x_nearest(x, axes=(2, 3))


class Conv3x3(nn.Module):
    """Padded (wrap or zero) 3x3 conv, reference key ``conv.weight``."""

    def __init__(self, cin: int, cout: int, wrap: bool = True):
        super().__init__()
        self.conv = PadConv2d(cin, cout, 3, wrap=wrap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConvELU(nn.Module):
    """Conv3x3 + ELU (reference ``ConvBlock``, keys ``conv.conv.*``)."""

    def __init__(self, cin: int, cout: int, wrap: bool = True):
        super().__init__()
        self.conv = Conv3x3(cin, cout, wrap)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.elu(self.conv(x))


def _depth_decoder(wrap: bool, enc: tuple) -> dict:
    """UniFuse's decoder convs by reference name: ``upconv_{l}``,
    ``deconv_{l}`` and the depth head ``depthconv_0``, on encoder maps of
    ``enc`` channels."""
    dec = NUM_CH_DEC
    up_ch = {5: dec[4], 1: dec[0]}
    for lvl in (4, 3, 2):
        up_ch[lvl] = dec[lvl - 1]
    mods = {"upconv_5": ConvELU(enc[4], up_ch[5], wrap),
            "deconv_0": ConvELU(dec[0], dec[0], wrap),
            "depthconv_0": Conv3x3(dec[0], 1, wrap)}
    for lvl in (4, 3, 2, 1):
        mods[f"deconv_{lvl}"] = ConvELU(up_ch[lvl + 1] + enc[lvl - 1],
                                        dec[lvl], wrap)
        mods[f"upconv_{lvl}"] = ConvELU(dec[lvl], up_ch[lvl], wrap)
    return mods


def _cube_to_erp(cube_feats: list, b: int, h: int, w: int):
    """``feat(level)``: the level's cube features (B*6, C, f, f)
    resampled to ERP (B, C, H >> level, W >> level)."""
    def feat(level: int) -> torch.Tensor:
        cf = cube_feats[level - 1]
        c, f = cf.shape[1], cf.shape[2]
        stacked = cf.permute(0, 2, 3, 1).reshape(b, 6, f, f, c)
        return cubemap.cube_to_equi(stacked, h >> level,
                                    w >> level).permute(0, 3, 1, 2)
    return feat


def _encode_cube(encoder: nn.Module, cube: torch.Tensor) -> list:
    b, six, fw = cube.shape[:3]
    assert six == 6
    return encoder(cube.reshape(b * 6, fw, fw, 3).permute(0, 3, 1, 2))


class UniFuse(nn.Module):
    """Two-branch 360 mono-depth network.

    ``forward(equi (B, H, W, 3), cube (B, 6, H/2, H/2, 3))``, both
    ImageNet-normalised, returns ``pred_depth`` (B, H, W, 1) and
    ``mono_feat`` (B, H/2, W/2, 32: the deconv_1 tap the MVS net reads).
    """

    order = UNIFUSE_DECODER_ORDER

    def __init__(self, max_depth: float = 10.0, fusion_type: str = "cee",
                 se_in_fusion: bool = True, wrap: bool = True,
                 num_layers: int = 18):
        super().__init__()
        self.max_depth = max_depth
        self.equi_encoder = make_encoder(num_layers, wrap)
        self.cube_encoder = make_encoder(num_layers, wrap=False)
        enc = self.equi_encoder.num_ch_enc
        mods = _depth_decoder(wrap, enc)
        for lvl in (5, 4, 3, 2, 1):
            mods[f"fusion_{lvl}"] = make_fusion(fusion_type, enc[lvl - 1],
                                                se_in_fusion)
        self.equi_decoder = nn.ModuleList(mods[n] for n in self.order)

    def forward(self, equi: torch.Tensor, cube: torch.Tensor) -> dict:
        b, h, w, _ = equi.shape
        assert cube.shape[2] == h // 2
        equi_feats = self.equi_encoder(equi.permute(0, 3, 1, 2))
        c2e = _cube_to_erp(_encode_cube(self.cube_encoder, cube), b, h, w)
        d = dict(zip(self.order, self.equi_decoder))

        def feat(level: int) -> torch.Tensor:
            """The level's ERP features fused with its cube features
            resampled to ERP."""
            return d[f"fusion_{level}"](equi_feats[level - 1], c2e(level))
        x = _up(d["upconv_5"](feat(5)))                          # 1/16
        for lvl in (4, 3, 2):
            x = d[f"deconv_{lvl}"](torch.cat([x, feat(lvl)], 1))
            x = _up(d[f"upconv_{lvl}"](x))
        x = d["deconv_1"](torch.cat([x, feat(1)], 1))
        # the MVS net reads this deconv_1 feature (32 ch at 1/2 res)
        outputs = {"mono_feat": x.permute(0, 2, 3, 1)}
        x = d["deconv_0"](_up(d["upconv_1"](x)))                 # 1/1
        outputs["pred_depth"] = (self.max_depth * torch.sigmoid(
            d["depthconv_0"](x))).permute(0, 2, 3, 1)
        return outputs


class Equi(nn.Module):
    """ERP-only encoder/decoder: (B, H, W, 3) -> (B, H/4, W/4, 32)."""

    def __init__(self, wrap: bool = True, num_layers: int = 18):
        super().__init__()
        self.equi_encoder = make_encoder(num_layers, wrap)
        enc, dec = self.equi_encoder.num_ch_enc, NUM_CH_DEC
        mods = {"upconv_5": ConvELU(enc[4], dec[4], wrap)}
        for lvl in (4, 3):
            mods[f"deconv_{lvl}"] = ConvELU(dec[lvl] + enc[lvl - 1],
                                            dec[lvl], wrap)
            mods[f"upconv_{lvl}"] = ConvELU(dec[lvl], dec[lvl - 1], wrap)
        mods["deconv_2"] = ConvELU(dec[2] + enc[1], dec[2], wrap)
        mods["upconv_2"] = ConvELU(dec[2], dec[1], wrap)
        self.equi_decoder = nn.ModuleList(mods[n]
                                          for n in EQUI_DECODER_ORDER)

    def forward(self, equi: torch.Tensor) -> torch.Tensor:
        feats = self.equi_encoder(equi.permute(0, 3, 1, 2))
        d = dict(zip(EQUI_DECODER_ORDER, self.equi_decoder))
        x = _up(d["upconv_5"](feats[4]))
        for lvl in (4, 3):
            x = d[f"deconv_{lvl}"](torch.cat([x, feats[lvl - 1]], 1))
            x = _up(d[f"upconv_{lvl}"](x))
        x = d["deconv_2"](torch.cat([x, feats[1]], 1))
        return d["upconv_2"](x).permute(0, 2, 3, 1)
