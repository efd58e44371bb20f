"""360-degree monocular depth networks and the Equi feature network.

Port of ``panogrf_tpu/models/unifuse.py``:

* ``UniFuse``: a ResNet ERP encoder and a ResNet cubemap encoder (the 6
  faces folded into the batch), per-level cube->ERP resampling fused into
  the ERP decoder, a sigmoid depth head;
* ``EquiDepth``: UniFuse without the cubemap branch (the ``Equi`` choice
  of ``select_mono``);
* ``ERPTPDepth``: UniFuse with N gnomonic tangent patches in place of
  the cube faces (the ``ERP+TP`` ablation; ``core/tangent.py``);
* ``CubeDepth``: the cube encoder alone, its features resampled to ERP
  and decoded with no fusion (the ``Cube`` ablation);
* ``Equi``: the ERP-only encoder/decoder that gives the MVS net its
  32-channel features at 1/4 resolution, optionally with a sin(latitude)
  input channel (``with_sin``);
* ``MONO_NETS`` and ``select_mono``, the config-driven factory.

Each net takes the ResNet-18/34 or MobileNetV2 encoder (``num_layers`` 18,
34 or 2), and each mono net has the optional (mu, sigma) ``uncertainty``
head.  Parameter names are the reference layout that
``torch_convert.convert_unifuse``, ``convert_equi_depth`` and
``convert_equi`` read: encoders under ``equi_encoder``/``cube_encoder``
and the decoder as one flat ModuleList ``equi_decoder.{i}`` in the
reference's registration order.  ``CubeDepth`` and ``ERPTPDepth`` have no
reference converter: ``CubeDepth`` uses ``EquiDepth``'s decoder layout,
``ERPTPDepth`` UniFuse's with its patch encoder under ``tp_encoder``.
Inputs and outputs are channel-last, as in the JAX package; the convs run
NCHW.  Training mode is the modules' ``train()``: BatchNorm then uses and
updates batch statistics (``nn/resnet.BatchNorm2d``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.core import cubemap, tangent
from panogrf_tpu_torch.nn.blocks import PadConv2d, upsample2x_nearest
from panogrf_tpu_torch.nn.fusion import make_fusion
from panogrf_tpu_torch.nn.resnet import make_encoder
from panogrf_tpu_torch.utils.spans import span

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
# decoder ModuleList order of EquiDepth (and of CubeDepth)
EQUI_DEPTH_DECODER_ORDER = EQUI_DECODER_ORDER + (
    "deconv_1", "upconv_1", "deconv_0", "depthconv_0")


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


def _depth_decoder(wrap: bool, enc: tuple, narrow: bool = False) -> dict:
    """The mono nets' decoder convs by reference name: ``upconv_{l}``,
    ``deconv_{l}`` and the depth head ``depthconv_0``, on encoder maps of
    ``enc`` channels.  ``narrow`` is the JAX package's ``CubeDepth`` and
    ``ERPTPDepth`` ladder, whose ``upconv_{4,3,2}`` give
    ``NUM_CH_DEC[l - 2]`` channels where UniFuse's give
    ``NUM_CH_DEC[l - 1]``."""
    dec = NUM_CH_DEC
    up_ch = {5: dec[4], 1: dec[0]}
    for lvl in (4, 3, 2):
        up_ch[lvl] = dec[lvl - 2] if narrow else dec[lvl - 1]
    mods = {"upconv_5": ConvELU(enc[4], up_ch[5], wrap),
            "deconv_0": ConvELU(dec[0], dec[0], wrap),
            "depthconv_0": Conv3x3(dec[0], 1, wrap)}
    for lvl in (4, 3, 2, 1):
        mods[f"deconv_{lvl}"] = ConvELU(up_ch[lvl + 1] + enc[lvl - 1],
                                        dec[lvl], wrap)
        mods[f"upconv_{lvl}"] = ConvELU(dec[lvl], up_ch[lvl], wrap)
    return mods


class _MonoDepth(nn.Module):
    """The decoder ladder and heads the mono nets share.  Subclasses
    register ``equi_decoder`` (a ModuleList in ``self.order``) and call
    ``decode`` with ``feat(level)``, the NCHW map fed in at each level
    5..1."""

    order: tuple = EQUI_DEPTH_DECODER_ORDER

    def _fused_decoder(self, fusion_type: str, se_in_fusion: bool,
                       wrap: bool, narrow: bool = False):
        """The decoder with a fusion layer at each level (UniFuse's; the
        narrow ladder is ``ERPTPDepth``'s)."""
        enc = self.equi_encoder.num_ch_enc
        mods = _depth_decoder(wrap, enc, narrow)
        for lvl in (5, 4, 3, 2, 1):
            mods[f"fusion_{lvl}"] = make_fusion(fusion_type, enc[lvl - 1],
                                                se_in_fusion)
        self.equi_decoder = nn.ModuleList(mods[n] for n in self.order)

    def _heads(self, max_depth: float, uncertainty: bool, wrap: bool):
        self.max_depth = max_depth
        self.uncert_head = (Conv3x3(NUM_CH_DEC[0], 2, wrap) if uncertainty
                            else None)

    def decode(self, feat) -> dict:
        """Run the ladder on ``feat(level)`` and the heads: ``mono_feat``
        (B, H/2, W/2, 32), ``pred_depth`` (B, H, W, 1) and with the
        uncertainty head ``pred`` (B, H, W, 2) = (mu, sigma)."""
        d = dict(zip(self.order, self.equi_decoder))
        x = _up(d["upconv_5"](feat(5)))                          # 1/16
        for lvl in (4, 3, 2):
            x = d[f"deconv_{lvl}"](torch.cat([x, feat(lvl)], 1))
            x = _up(d[f"upconv_{lvl}"](x))
        x = d["deconv_1"](torch.cat([x, feat(1)], 1))
        # the MVS net reads this deconv_1 feature (32 ch at 1/2 res)
        outputs = {"mono_feat": x.permute(0, 2, 3, 1)}
        x = d["deconv_0"](_up(d["upconv_1"](x)))                 # 1/1
        outputs["pred_depth"] = self.depth_head(
            d["depthconv_0"](x)).permute(0, 2, 3, 1)
        if self.uncert_head is not None:
            pred = self.uncert_head(x)
            mu = self.max_depth * torch.sigmoid(pred[:, :1])
            sigma = F.softplus(pred[:, 1:]) + 1e-3
            outputs["pred"] = torch.cat([mu, sigma], 1).permute(0, 2, 3, 1)
        return outputs

    def depth_head(self, out: torch.Tensor) -> torch.Tensor:
        return self.max_depth * torch.sigmoid(out)


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


class UniFuse(_MonoDepth):
    """Two-branch 360 mono-depth network.

    ``forward(equi (B, H, W, 3), cube (B, 6, H/2, H/2, 3))``, both
    ImageNet-normalised, returns ``pred_depth`` (B, H, W, 1),
    ``mono_feat`` (B, H/2, W/2, 32: the deconv_1 tap the MVS net reads)
    and, with ``uncertainty``, ``pred`` (B, H, W, 2) = (mu, sigma).
    """

    order = UNIFUSE_DECODER_ORDER

    def __init__(self, max_depth: float = 10.0, min_depth: float = 0.1,
                 fusion_type: str = "cee", se_in_fusion: bool = True,
                 wrap: bool = True, out_type: str = "depth",
                 uncertainty: bool = False, num_layers: int = 18):
        super().__init__()
        self.min_depth = min_depth
        self.out_type = out_type
        self.equi_encoder = make_encoder(num_layers, wrap)
        self.cube_encoder = make_encoder(num_layers, wrap=False)
        self._fused_decoder(fusion_type, se_in_fusion, wrap)
        self._heads(max_depth, uncertainty, wrap)

    def depth_head(self, out: torch.Tensor) -> torch.Tensor:
        if self.out_type == "disparity":
            max_disp, min_disp = 1.0 / self.min_depth, 1.0 / self.max_depth
            return 1.0 / (torch.sigmoid(out) * (max_disp - min_disp)
                          + min_disp)
        return super().depth_head(out)

    def forward(self, equi: torch.Tensor, cube: torch.Tensor) -> dict:
        b, h, w, _ = equi.shape
        assert cube.shape[2] == h // 2
        with span("mono"):
            equi_feats = self.equi_encoder(equi.permute(0, 3, 1, 2))
            c2e = _cube_to_erp(_encode_cube(self.cube_encoder, cube), b, h,
                               w)
            fusion = dict(zip(self.order, self.equi_decoder))

            def feat(level: int) -> torch.Tensor:
                """The level's ERP features fused with its cube features
                resampled to ERP."""
                return fusion[f"fusion_{level}"](equi_feats[level - 1],
                                                 c2e(level))
            return self.decode(feat)


class EquiDepth(_MonoDepth):
    """ERP-only mono-depth network: UniFuse's decoder ladder and heads on
    the ERP encoder alone.  ``forward(equi (B, H, W, 3))``."""

    def __init__(self, max_depth: float = 10.0, wrap: bool = True,
                 uncertainty: bool = False, num_layers: int = 18):
        super().__init__()
        self.equi_encoder = make_encoder(num_layers, wrap)
        mods = _depth_decoder(wrap, self.equi_encoder.num_ch_enc)
        self.equi_decoder = nn.ModuleList(mods[n] for n in self.order)
        self._heads(max_depth, uncertainty, wrap)

    def forward(self, equi: torch.Tensor) -> dict:
        feats = self.equi_encoder(equi.permute(0, 3, 1, 2))
        return self.decode(lambda level: feats[level - 1])


class ERPTPDepth(_MonoDepth):
    """ERP + tangent-patch mono-depth network: UniFuse with its second
    branch on ``NPATCHES[nrows]`` gnomonic patches of ``patch_size``
    pixels (``fov`` degrees) instead of the 6 cube faces, folded into the
    batch; each level's patch features are resampled to ERP and fused into
    a decoder of ``CubeDepth``'s narrower ladder, as in the JAX package.
    ``forward(equi (B, H, W, 3))``."""

    order = UNIFUSE_DECODER_ORDER

    def __init__(self, max_depth: float = 10.0, fusion_type: str = "cee",
                 se_in_fusion: bool = True, wrap: bool = True,
                 uncertainty: bool = False, num_layers: int = 18,
                 nrows: int = 4, patch_size: int = 64, fov: float = 80.0):
        super().__init__()
        self.nrows, self.patch_size, self.fov = nrows, patch_size, fov
        self.equi_encoder = make_encoder(num_layers, wrap)
        self.tp_encoder = make_encoder(num_layers, wrap=False)
        self._fused_decoder(fusion_type, se_in_fusion, wrap, narrow=True)
        self._heads(max_depth, uncertainty, wrap)

    def forward(self, equi: torch.Tensor) -> dict:
        b, h, w, c = equi.shape
        ps, fov = self.patch_size, (self.fov, self.fov)
        equi_feats = self.equi_encoder(equi.permute(0, 3, 1, 2))
        patches = tangent.equi_to_tangent(equi, self.nrows, (ps, ps), fov)
        tp_feats = self.tp_encoder(
            patches.reshape(-1, ps, ps, c).permute(0, 3, 1, 2))
        fusion = dict(zip(self.order, self.equi_decoder))

        def feat(level: int) -> torch.Tensor:
            """The level's ERP features fused with its patch features
            resampled to ERP."""
            tf = tp_feats[level - 1]
            f = tf.shape[2]
            grouped = tf.permute(0, 2, 3, 1).reshape(b, -1, f, f,
                                                     tf.shape[1])
            t2e = tangent.tangent_to_equi(grouped, (h >> level, w >> level),
                                          self.nrows, fov)
            return fusion[f"fusion_{level}"](equi_feats[level - 1],
                                             t2e.permute(0, 3, 1, 2))
        return self.decode(feat)


class CubeDepth(_MonoDepth):
    """Cubemap-only mono-depth network: only the cube encoder runs, and
    the decoder reads its features resampled to ERP, with no ERP branch
    and no fusion; its ladder is the JAX package's narrower one (see
    ``_depth_decoder``).  ``forward(equi (B, H, W, 3), cube (B, 6, H/2,
    H/2, 3))``; ``equi`` gives only the output size."""

    def __init__(self, max_depth: float = 10.0, wrap: bool = True,
                 uncertainty: bool = False, num_layers: int = 18):
        super().__init__()
        self.cube_encoder = make_encoder(num_layers, wrap=False)
        mods = _depth_decoder(wrap, self.cube_encoder.num_ch_enc,
                              narrow=True)
        self.equi_decoder = nn.ModuleList(mods[n] for n in self.order)
        self._heads(max_depth, uncertainty, wrap)

    def forward(self, equi: torch.Tensor, cube: torch.Tensor) -> dict:
        b, h, w, _ = equi.shape
        assert cube.shape[2] == h // 2
        return self.decode(_cube_to_erp(
            _encode_cube(self.cube_encoder, cube), b, h, w))


def sin_channel(b: int, h: int, w: int, device) -> torch.Tensor:
    """sin(latitude from the pole) per row, (B, H, W, 1):
    sin((arange(h) + 0.5) * pi / h)."""
    phi = torch.sin((torch.arange(h, dtype=torch.float32, device=device)
                     + 0.5) * math.pi / h)
    return phi[None, :, None, None].expand(b, h, w, 1)


class Equi(nn.Module):
    """ERP-only encoder/decoder: (B, H, W, 3) -> (B, H/4, W/4, 32);
    ``with_sin`` appends the :func:`sin_channel` to the input (a 4-channel
    first conv)."""

    def __init__(self, wrap: bool = True, with_sin: bool = False,
                 num_layers: int = 18):
        super().__init__()
        self.with_sin = with_sin
        self.equi_encoder = make_encoder(num_layers, wrap,
                                         4 if with_sin else 3)
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
        if self.with_sin:
            equi = torch.cat([equi, sin_channel(*equi.shape[:3],
                                                equi.device)], -1)
        feats = self.equi_encoder(equi.permute(0, 3, 1, 2))
        d = dict(zip(EQUI_DECODER_ORDER, self.equi_decoder))
        x = _up(d["upconv_5"](feats[4]))
        for lvl in (4, 3):
            x = d[f"deconv_{lvl}"](torch.cat([x, feats[lvl - 1]], 1))
            x = _up(d[f"upconv_{lvl}"](x))
        x = d["deconv_2"](torch.cat([x, feats[1]], 1))
        return d["upconv_2"](x).permute(0, 2, 3, 1)


MONO_NETS = ("UniFuse", "Equi", "ERP+TP", "Cube")


def select_mono(cfg, mvsnet: bool = False) -> nn.Module:
    """The mono-depth network a config names (``mono_net``), with its
    ``mono_uncertainty`` head, ``max_depth``, ``use_wrap_padding`` and
    encoder depth.  ``mvsnet`` picks the ``mono_*`` knobs (the frozen mono
    net inside the MVS pipeline); the standalone mono trainer reads
    ``num_layers``/``fusion`` first; ``ERP+TP`` reads ``nrows``,
    ``patchsize`` and ``fov``.  ``cfg`` is a mapping or an object with
    those attributes."""
    get = (cfg.get if hasattr(cfg, "get")
           else lambda k, d=None: getattr(cfg, k, d))
    name = get("mono_net", "UniFuse")
    uncert = bool(get("mono_uncertainty", False))
    max_depth = float(get("max_depth", 10.0))
    wrap = bool(get("use_wrap_padding", True))
    if mvsnet:
        layers = int(get("mono_num_layers", 18))
        fusion = str(get("mono_fusion", "cee"))
    else:
        layers = int(get("num_layers", get("mono_num_layers", 18)))
        fusion = str(get("fusion", get("mono_fusion", "cee")))
    if name not in MONO_NETS:
        raise ValueError(f"unknown mono_net {name!r}; available: "
                         f"{MONO_NETS}")
    if name == "UniFuse":
        return UniFuse(max_depth=max_depth, uncertainty=uncert, wrap=wrap,
                       num_layers=layers, fusion_type=fusion,
                       se_in_fusion=bool(get("se_in_fusion", True)))
    if name == "ERP+TP":
        return ERPTPDepth(max_depth=max_depth, uncertainty=uncert, wrap=wrap,
                          num_layers=layers, fusion_type=fusion,
                          se_in_fusion=bool(get("se_in_fusion", True)),
                          nrows=int(get("nrows", 4)),
                          patch_size=int(get("patchsize", 64)),
                          fov=float(get("fov", 80.0)))
    cls = EquiDepth if name == "Equi" else CubeDepth
    return cls(max_depth=max_depth, uncertainty=uncert, wrap=wrap,
               num_layers=layers)
