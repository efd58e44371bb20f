"""UniFuse 360-degree monocular depth and the Equi feature network.

Port of ``UniFuse`` and ``Equi`` from ``panogrf_tpu/models/unifuse.py``:

* ``UniFuse``: a ResNet ERP encoder and a ResNet cubemap encoder (the 6
  faces folded into the batch), per-level cube->ERP resampling fused into
  the ERP decoder, a sigmoid depth head;
* ``Equi``: the ERP-only encoder/decoder that gives the MVS net its
  32-channel features at 1/4 resolution.

Parameter names are the reference layout that
``torch_convert.convert_unifuse``/``convert_equi`` read: encoders under
``equi_encoder``/``cube_encoder`` and the decoder as one flat ModuleList
``equi_decoder.{i}`` in the reference's registration order.  Inputs and
outputs are channel-last, as in the JAX package; the convs run NCHW.
``EquiDepth``, ``ERPTPDepth``, ``CubeDepth`` and ``select_mono`` are not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.core import cubemap
from panogrf_tpu_torch.nn.blocks import PadConv2d, upsample2x_nearest
from panogrf_tpu_torch.nn.fusion import make_fusion
from panogrf_tpu_torch.nn.resnet import make_encoder

# torchvision-resnet18 encoder channels / decoder channels
NUM_CH_ENC = (64, 64, 128, 256, 512)
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


class UniFuse(nn.Module):
    """Two-branch 360 mono-depth network.

    ``forward(equi (B, H, W, 3), cube (B, 6, H/2, H/2, 3))``, both
    ImageNet-normalised, returns ``pred_depth`` (B, H, W, 1),
    ``mono_feat`` (B, H/2, W/2, 32: the deconv_1 tap the MVS net reads)
    and, with ``uncertainty``, ``pred`` (B, H, W, 2) = (mu, sigma).
    """

    def __init__(self, max_depth: float = 10.0, min_depth: float = 0.1,
                 fusion_type: str = "cee", se_in_fusion: bool = True,
                 wrap: bool = True, out_type: str = "depth",
                 uncertainty: bool = False, num_layers: int = 18):
        super().__init__()
        self.max_depth, self.min_depth = max_depth, min_depth
        self.out_type = out_type
        self.equi_encoder = make_encoder(num_layers, wrap)
        self.cube_encoder = make_encoder(num_layers, wrap=False)
        enc, dec = NUM_CH_ENC, NUM_CH_DEC
        mods = {
            "fusion_5": make_fusion(fusion_type, enc[4], se_in_fusion),
            "upconv_5": ConvELU(enc[4], dec[4], wrap),
            "deconv_0": ConvELU(dec[0], dec[0], wrap),
            "depthconv_0": Conv3x3(dec[0], 1, wrap),
        }
        for lvl in (4, 3, 2, 1):
            mods[f"fusion_{lvl}"] = make_fusion(fusion_type, enc[lvl - 1],
                                                se_in_fusion)
            mods[f"deconv_{lvl}"] = ConvELU(dec[lvl] + enc[lvl - 1],
                                            dec[lvl], wrap)
            mods[f"upconv_{lvl}"] = ConvELU(dec[lvl], dec[lvl - 1], wrap)
        self.equi_decoder = nn.ModuleList(mods[n]
                                          for n in UNIFUSE_DECODER_ORDER)
        self.uncert_head = Conv3x3(dec[0], 2, wrap) if uncertainty else None

    def forward(self, equi: torch.Tensor, cube: torch.Tensor) -> dict:
        b, h, w, _ = equi.shape
        assert cube.shape[1] == 6 and cube.shape[2] == h // 2
        fw = cube.shape[2]
        equi_feats = self.equi_encoder(equi.permute(0, 3, 1, 2))
        cube_feats = self.cube_encoder(
            cube.reshape(b * 6, fw, fw, 3).permute(0, 3, 1, 2))
        d = dict(zip(UNIFUSE_DECODER_ORDER, self.equi_decoder))

        def fusion(level: int) -> torch.Tensor:
            """Fuse the level's ERP features with its cube features
            resampled to ERP."""
            cf = cube_feats[level - 1]
            c, f = cf.shape[1], cf.shape[2]
            stacked = cf.permute(0, 2, 3, 1).reshape(b, 6, f, f, c)
            c2e = cubemap.cube_to_equi(stacked, h >> level, w >> level)
            return d[f"fusion_{level}"](equi_feats[level - 1],
                                        c2e.permute(0, 3, 1, 2))

        x = _up(d["upconv_5"](fusion(5)))                        # 1/16
        for lvl in (4, 3, 2):
            x = d[f"deconv_{lvl}"](torch.cat([x, fusion(lvl)], 1))
            x = _up(d[f"upconv_{lvl}"](x))
        x = d["deconv_1"](torch.cat([x, fusion(1)], 1))
        # the MVS net reads this deconv_1 feature (32 ch at 1/2 res)
        outputs = {"mono_feat": x.permute(0, 2, 3, 1)}
        x = d["deconv_0"](_up(d["upconv_1"](x)))                 # 1/1
        equi_out = d["depthconv_0"](x)
        if self.out_type == "disparity":
            max_disp, min_disp = 1.0 / self.min_depth, 1.0 / self.max_depth
            depth = 1.0 / (torch.sigmoid(equi_out) * (max_disp - min_disp)
                           + min_disp)
        else:
            depth = self.max_depth * torch.sigmoid(equi_out)
        outputs["pred_depth"] = depth.permute(0, 2, 3, 1)
        if self.uncert_head is not None:
            pred = self.uncert_head(x)
            mu = self.max_depth * torch.sigmoid(pred[:, :1])
            sigma = F.softplus(pred[:, 1:]) + 1e-3
            outputs["pred"] = torch.cat([mu, sigma], 1).permute(0, 2, 3, 1)
        return outputs


class Equi(nn.Module):
    """ERP-only encoder/decoder: (B, H, W, 3) -> (B, H/4, W/4, 32)."""

    def __init__(self, wrap: bool = True, with_sin: bool = False,
                 num_layers: int = 18):
        super().__init__()
        if with_sin:
            raise NotImplementedError("Equi with_sin is not ported to "
                                      "panogrf_tpu_torch yet")
        self.equi_encoder = make_encoder(num_layers, wrap)
        enc, dec = NUM_CH_ENC, NUM_CH_DEC
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
