"""Carry parameters between the JAX package and the port.

Each ``*_state_dict`` is the inverse of a converter of
``panogrf_tpu/utils/torch_convert``: a JAX module's variables (nested
dicts of numpy arrays) become a state dict in the reference PyTorch
layout, which the port's modules use.

* ``renderer_state_dict``: ``NeuralRayGenRenderer`` params, inverse of
  ``convert_renderer``;
* ``ft_renderer_state_dict``: ``NeuralRayFtRenderer`` params: the gen
  renderer's keys without ``init_net.*``, and the (rfn, fh, fw, F)
  ``ray_feats`` as one (1, F, fh, fw) ``ray_feats.{i}`` per view, the
  layout ``extract_ray_feats`` reads;
* ``unifuse_state_dict``: ``UniFuse`` params + batch_stats, inverse of
  ``convert_unifuse`` (which leaves out the uncertainty head);
* ``equi_depth_state_dict``: ``EquiDepth``, inverse of
  ``convert_equi_depth`` (idem);
* ``cube_depth_state_dict``: ``CubeDepth``, which has no converter in
  the JAX package: its encoder is ``cube_encoder`` and its decoder has
  ``EquiDepth``'s layout;
* ``unifuse_state_dict`` also serves ``ERPTPDepth``, which has no
  converter: UniFuse's layout with its patch encoder under ``tp_encoder``;
* ``mvs_state_dict``: ``MVSDepthModel`` params + batch_stats, inverse of
  ``convert_mvs`` (with ``mvs_uncertainty`` the last head block has two
  output channels under the same keys; ``with_sin`` widens the first
  conv and the head's input); ``CostRegNet`` (``use_new_reg3dnet``) goes
  under ``unet3d``, inverse of ``convert_cost_reg``, and the ERP+TP / TP /
  Cube feature nets under ``unet`` in ``nn/erp_tp.py``'s layout;
* ``fnet_state_dict``: ``FNetDepthModel``; ``uncert_head_state_dict``:
  ``DepthUncertHead`` (the port's layouts, no converter).

Every encoder may be a ResNet or, with ``num_layers`` 2, a MobileNetV2
(torchvision ``features.{i}`` keys); every uncertainty head
(``uncert_head`` of the mono nets) is carried; the renderer's image
encoder and init net may be ``ERPTPEncoder``s.

Conv kernels (k..., I, O) become (O, I, k...), Dense kernels (in, out)
become Linear weights (out, in), GroupNorm ``scale``/``bias`` become the
instance norms' ``weight``/``bias``, and BatchNorm ``scale``/``bias`` and
``mean``/``var`` become ``weight``/``bias`` and
``running_mean``/``running_var`` (with ``num_batches_tracked`` 0).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from panogrf_tpu_torch.models.fnet import FNetDepthModel
from panogrf_tpu_torch.models.mvs import MVSDepthModel
from panogrf_tpu_torch.models.uncert import DepthUncertHead
from panogrf_tpu_torch.models.unifuse import (EQUI_DEPTH_DECODER_ORDER,
                                              UNIFUSE_DECODER_ORDER,
                                              CubeDepth, EquiDepth,
                                              ERPTPDepth, UniFuse)
from panogrf_tpu_torch.renderer.ft_renderer import NeuralRayFtRenderer

_POOL_STACKS = ("ray_dir_fc", "neuray_fc", "base_fc", "vis_fc", "vis_fc2",
                "geometry_fc", "rgb_fc")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


# the JAX UniFuse's call order of its anonymous ConvELU and fusion
# modules, by their names in the reference decoder
_CONVELU_ORDER = ("upconv_5", "deconv_4", "upconv_4", "deconv_3",
                  "upconv_3", "deconv_2", "upconv_2", "deconv_1",
                  "upconv_1", "deconv_0")
_FUSION_ORDER = ("fusion_5", "fusion_4", "fusion_3", "fusion_2", "fusion_1")
_BLOCK_COUNTS = {8: (2, 2, 2, 2), 16: (3, 4, 6, 3)}


class _StateDict(dict):
    def conv(self, key: str, p: dict) -> None:
        k = np.asarray(p["kernel"])
        n = k.ndim
        self[f"{key}.weight"] = _t(np.transpose(k, (n - 1, n - 2,
                                                    *range(n - 2))))
        if "bias" in p:
            self[f"{key}.bias"] = _t(p["bias"])

    def batch_norm(self, key: str, p: dict, s: dict) -> None:
        self[f"{key}.weight"] = _t(p["scale"])
        self[f"{key}.bias"] = _t(p["bias"])
        self[f"{key}.running_mean"] = _t(s["mean"])
        self[f"{key}.running_var"] = _t(s["var"])
        self[f"{key}.num_batches_tracked"] = torch.tensor(0)

    def encoder(self, prefix: str, p: dict, s: dict) -> None:
        """A ResNet or MobileNetV2 encoder -> torchvision keys."""
        if "InvertedResidual_0" in p:
            self.mobilenet(prefix, p, s)
        else:
            self.resnet(prefix, p, s)

    def conv_bn(self, key: str, p: dict, s: dict) -> None:
        """A ``_ConvBNReLU6`` -> ``{key}.0`` conv and ``{key}.1`` BN."""
        self.conv(f"{key}.0", p["Conv_0"])
        self.batch_norm(f"{key}.1", p["_BN_0"]["BatchNorm_0"],
                        s["_BN_0"]["BatchNorm_0"])

    def mobilenet(self, prefix: str, p: dict, s: dict) -> None:
        """``MobileNetV2Encoder`` -> torchvision ``features.{i}`` keys."""
        self.conv_bn(f"{prefix}.features.0", p["_ConvBNReLU6_0"],
                     s["_ConvBNReLU6_0"])
        i = 0
        while f"InvertedResidual_{i}" in p:
            bp, bs = p[f"InvertedResidual_{i}"], s[f"InvertedResidual_{i}"]
            t = f"{prefix}.features.{i + 1}.conv"
            n = sum(k.startswith("_ConvBNReLU6_") for k in bp)
            for j in range(n):
                self.conv_bn(f"{t}.{j}", bp[f"_ConvBNReLU6_{j}"],
                             bs[f"_ConvBNReLU6_{j}"])
            self.conv(f"{t}.{n}", bp["Conv_0"])
            self.batch_norm(f"{t}.{n + 1}", bp["_BN_0"]["BatchNorm_0"],
                            bs["_BN_0"]["BatchNorm_0"])
            i += 1

    def resnet(self, prefix: str, p: dict, s: dict) -> None:
        """``ResNetEncoder`` -> torchvision keys."""
        self.conv(f"{prefix}.conv1", p["_ConvPad_0"]["Conv_0"])
        self.batch_norm(f"{prefix}.bn1", p["_BN_0"]["BatchNorm_0"],
                        s["_BN_0"]["BatchNorm_0"])
        counts = _BLOCK_COUNTS[sum(k.startswith("ResNetBasicBlock_")
                                   for k in p)]
        blk = 0
        for li, nblocks in enumerate(counts, start=1):
            for bi in range(nblocks):
                t = f"{prefix}.layer{li}.{bi}"
                bp, bs = p[f"ResNetBasicBlock_{blk}"], \
                    s[f"ResNetBasicBlock_{blk}"]
                for i in (0, 1):
                    self.conv(f"{t}.conv{i + 1}",
                              bp[f"_ConvPad_{i}"]["Conv_0"])
                    self.batch_norm(f"{t}.bn{i + 1}",
                                    bp[f"_BN_{i}"]["BatchNorm_0"],
                                    bs[f"_BN_{i}"]["BatchNorm_0"])
                if "downsample_conv" in bp:
                    self.conv(f"{t}.downsample.0", bp["downsample_conv"])
                    self.batch_norm(f"{t}.downsample.1",
                                    bp["downsample_bn"]["BatchNorm_0"],
                                    bs["downsample_bn"]["BatchNorm_0"])
                blk += 1

    def fusion(self, t: str, p: dict, s: dict | None) -> None:
        """A CEE, Concat or BiProj fusion layer."""
        if "res_conv1" in p:
            for name in ("res_conv1", "res_conv2", "conv"):
                self.conv(f"{t}.{name}", p[name])
            for name in ("res_bn1", "res_bn2"):
                self.batch_norm(f"{t}.{name}", p[name], s[name])
            if "SELayer_0" in p:
                se = p["SELayer_0"]
                self.dense(f"{t}.selayer.fc.0", se["Dense_0"]["kernel"])
                self.dense(f"{t}.selayer.fc.2", se["Dense_1"]["kernel"])
        elif "conv_e2c" in p:
            for name in ("conv_e2c", "conv_c2e", "conv_mask"):
                self.conv(f"{t}.{name}.0", p[name])
        else:
            self.conv(f"{t}.conv", p["Conv_0"])

    def uncert_head(self, p: dict) -> None:
        if "uncert_head" in p:
            self.conv("uncert_head.conv", p["uncert_head"]["Conv_0"])

    def conv3d_block(self, key: str, p: dict) -> None:
        self.conv(f"{key}.conv1", p["WrapConv3D_0"]["Conv_0"])
        self.conv(f"{key}.conv2", p["WrapConv3D_1"]["Conv_0"])

    def dense(self, key: str, w, b=None) -> None:
        self[f"{key}.weight"] = _t(np.transpose(w))
        if b is not None:
            self[f"{key}.bias"] = _t(b)

    def inorm(self, key: str, p: dict) -> None:
        self[f"{key}.weight"] = _t(p["GroupNorm_0"]["scale"])
        self[f"{key}.bias"] = _t(p["GroupNorm_0"]["bias"])

    def conv_in_elu(self, key: str, p: dict) -> None:
        self.conv(f"{key}.conv.1", p["WrapConv_0"]["Conv_0"])
        self.inorm(f"{key}.bn", p["InstanceNorm_0"])

    def basic_block(self, t: str, bp: dict) -> None:
        self.conv(f"{t}.conv1.1", bp["WrapConv_0"]["Conv_0"])
        self.inorm(f"{t}.bn1", bp["InstanceNorm_0"])
        self.conv(f"{t}.conv2.1", bp["WrapConv_1"]["Conv_0"])
        self.inorm(f"{t}.bn2", bp["InstanceNorm_1"])
        if "Conv_0" in bp:
            self.conv(f"{t}.downsample.0", bp["Conv_0"])
            self.inorm(f"{t}.downsample.1", bp["InstanceNorm_2"])

    def decoder_2x(self, prefix: str, p: dict, out: str) -> None:
        """ResUNetLight's decoder (upconv3, iconv3, upconv2, iconv2) and
        its 1x1 head ``out``."""
        self.conv_in_elu(f"{prefix}.upconv3.conv",
                         p["UpconvINELU_0"]["ConvINELU_0"])
        self.conv_in_elu(f"{prefix}.iconv3", p["ConvINELU_0"])
        self.conv_in_elu(f"{prefix}.upconv2.conv",
                         p["UpconvINELU_1"]["ConvINELU_0"])
        self.conv_in_elu(f"{prefix}.iconv2", p["ConvINELU_1"])
        self.conv(f"{prefix}.out_conv", p[out])

    def resunet(self, prefix: str, p: dict, layers) -> None:
        self.conv(f"{prefix}.conv1.1", p["Conv_0"])
        self.inorm(f"{prefix}.bn1", p["InstanceNorm_0"])
        blk = 0
        for li, nblocks in enumerate(layers, start=1):
            for bi in range(nblocks):
                self.basic_block(f"{prefix}.layer{li}.{bi}",
                                 p[f"BasicBlock_{blk}"])
                blk += 1
        self.decoder_2x(prefix, p, "Conv_1")

    def erp_tp(self, prefix: str, p: dict, s: dict, layers) -> None:
        """``ERPTPEncoder``: the JAX package creates the stems (ERP, then
        tangent) and, per stage, the ERP branch's blocks, the tangent
        branch's and the fusion layer in that order."""
        self.conv(f"{prefix}.conv1.1", p["Conv_0"])
        self.inorm(f"{prefix}.bn1", p["InstanceNorm_0"])
        self.conv(f"{prefix}.tp_conv1.1", p["Conv_1"])
        self.inorm(f"{prefix}.tp_bn1", p["InstanceNorm_1"])
        blk = 0
        for li, nblocks in enumerate(layers, start=1):
            for branch in ("layer", "tp_layer"):
                for bi in range(nblocks):
                    self.basic_block(f"{prefix}.{branch}{li}.{bi}",
                                     p[f"BasicBlock_{blk}"])
                    blk += 1
            kind = next(k for k in (f"CEELayer_{li - 1}", f"Concat_{li - 1}",
                                    f"BiProj_{li - 1}") if k in p)
            self.fusion(f"{prefix}.fusion{li}", p[kind], s.get(kind))
        self.decoder_2x(prefix, p, "Conv_2")

    def image_encoder(self, prefix: str, p: dict, s: dict, layers) -> None:
        """A ``ResUNetLight`` or an ``ERPTPEncoder``."""
        if "Conv_2" in p:
            self.erp_tp(prefix, p, s, layers)
        else:
            self.resunet(prefix, p, layers)

    def single_branch(self, prefix: str, p: dict) -> None:
        """``TPOnlyEncoder`` / ``CubeOnlyEncoder``."""
        for i in range(3):
            self.basic_block(f"{prefix}.layer.{i}", p[f"BasicBlock_{i}"])

    def conv_res_conv(self, prefix: str, p: dict, num_res: int) -> None:
        self.conv(f"{prefix}.0.1", p["WrapConv_0"]["Conv_0"])
        for i in range(num_res):
            t, rp = f"{prefix}.{1 + i}", p[f"ResidualBlock_{i}"]
            self.inorm(f"{t}.conv.0", rp["InstanceNorm_0"])
            self.conv(f"{t}.conv.3", rp["WrapConv_0"]["Conv_0"])
            self.inorm(f"{t}.conv.4", rp["InstanceNorm_1"])
            self.conv(f"{t}.conv.7", rp["WrapConv_1"]["Conv_0"])
        self.conv(f"{prefix}.{1 + num_res}", p["Conv_0"])

    def dist_decoder(self, prefix: str, p: dict) -> None:
        for head, hp in p.items():
            for i, idx in enumerate((0, 2, 4)):
                self.dense(f"{prefix}.{head}.{idx}", hp[f"w{i}"], hp[f"b{i}"])

    def agg_net(self, prefix: str, p: dict) -> None:
        for i in range(2):
            pe = p[f"prob_embed_{i}"]
            self.dense(f"{prefix}.prob_embed.{2 * i}", pe["kernel"],
                       pe["bias"])
        impl, a = p["agg_impl"], f"{prefix}.agg_impl"
        for name in _POOL_STACKS:
            i = 0
            while f"{name}_w{i}" in impl:
                self.dense(f"{a}.{name}.{2 * i}", impl[f"{name}_w{i}"],
                           impl[f"{name}_b{i}"])
                i += 1
        og = impl["out_geometry_fc"]
        for i in range(2):
            self.dense(f"{a}.out_geometry_fc.{2 * i}", og[f"w{i}"],
                       og[f"b{i}"])
        att = impl["ray_attention"]
        for lin in ("w_qs", "w_ks", "w_vs", "fc"):
            self.dense(f"{a}.ray_attention.{lin}", att[lin]["kernel"])
        self[f"{a}.ray_attention.layer_norm.weight"] = _t(
            att["LayerNorm_0"]["scale"])
        self[f"{a}.ray_attention.layer_norm.bias"] = _t(
            att["LayerNorm_0"]["bias"])


def _shared_renderer_modules(sd: _StateDict, p: dict, s: dict) -> None:
    """The modules the gen and the ft renderer share."""
    sd.image_encoder("image_encoder", p["image_encoder"],
                     s.get("image_encoder", {}), (1, 2, 6))
    sd.conv_res_conv("vis_encoder.out_conv", p["vis_encoder"], 2)
    # the fine modules exist only with hierarchical sampling
    for name in ("dist_decoder", "fine_dist_decoder"):
        if name in p:
            sd.dist_decoder(name, p[name])
    for name in ("agg_net", "fine_agg_net"):
        if name in p:
            sd.agg_net(name, p[name])


def renderer_state_dict(params: dict) -> dict:
    """The JAX ``NeuralRayGenRenderer``'s variables (or its params, with or
    without the outer ``{"params": ...}``) -> reference-layout state dict
    of CPU tensors; ERP+TP encoders need the ``batch_stats`` of their
    fusion layers."""
    p = params.get("params", params)
    s = params.get("batch_stats", {})
    sd = _StateDict()
    _shared_renderer_modules(sd, p, s)
    sd.image_encoder("init_net.res_net", p["init_net"]["res_net"],
                     s.get("init_net", {}).get("res_net", {}), (2, 3, 6))
    sd.conv_res_conv("init_net.depth_conv", p["init_net"]["depth_conv"], 1)
    sd.conv_res_conv("init_net.out_conv", p["init_net"]["out_conv"], 1)
    return dict(sd)


def ft_renderer_state_dict(params: dict) -> dict:
    """The JAX ``NeuralRayFtRenderer``'s params -> the reference ft state
    dict of CPU tensors."""
    p = params.get("params", params)
    sd = _StateDict()
    _shared_renderer_modules(sd, p, {})
    for i, rf in enumerate(np.asarray(p["ray_feats"])):
        sd[f"ray_feats.{i}"] = _t(np.transpose(rf, (2, 0, 1))[None])
    return dict(sd)


def unifuse_state_dict(variables: dict) -> dict:
    """The JAX ``UniFuse``'s variables (``params`` and ``batch_stats``) ->
    reference-layout state dict of CPU tensors; of ``ERPTPDepth``'s, whose
    second encoder is ``tp_encoder``, the same layout."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = _StateDict()
    for enc in ("equi_encoder", "cube_encoder", "tp_encoder"):
        if enc in p:
            sd.encoder(enc, p[enc], s[enc])
    index = {n: i for i, n in enumerate(UNIFUSE_DECODER_ORDER)}
    for i, name in enumerate(_CONVELU_ORDER):
        sd.conv(f"equi_decoder.{index[name]}.conv.conv",
                p[f"ConvELU_{i}"]["Conv_0"])
    sd.conv(f"equi_decoder.{index['depthconv_0']}.conv",
            p["Conv3x3Head_0"]["Conv_0"])
    for i, name in enumerate(_FUSION_ORDER):
        kind = next(k for k in (f"CEELayer_{i}", f"Concat_{i}",
                                f"BiProj_{i}") if k in p)
        sd.fusion(f"equi_decoder.{index[name]}", p[kind], s.get(kind))
    sd.uncert_head(p)
    return dict(sd)


def _single_branch_state_dict(variables: dict, encoder: str) -> dict:
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = _StateDict()
    sd.encoder(encoder, p[encoder], s[encoder])
    head = len(EQUI_DEPTH_DECODER_ORDER) - 1      # depthconv_0, last
    for i in range(head):
        sd.conv(f"equi_decoder.{i}.conv.conv", p[f"ConvELU_{i}"]["Conv_0"])
    sd.conv(f"equi_decoder.{head}.conv", p["Conv3x3Head_0"]["Conv_0"])
    sd.uncert_head(p)
    return dict(sd)


def equi_depth_state_dict(variables: dict) -> dict:
    """The JAX ``EquiDepth``'s variables -> reference-layout state dict."""
    return _single_branch_state_dict(variables, "equi_encoder")


def cube_depth_state_dict(variables: dict) -> dict:
    """The JAX ``CubeDepth``'s variables -> the port's state dict."""
    return _single_branch_state_dict(variables, "cube_encoder")


def mvs_state_dict(variables: dict) -> dict:
    """The JAX ``MVSDepthModel``'s variables -> reference-layout state dict
    of CPU tensors: the feature net (``Equi``, or an ERP+TP / TP / Cube
    encoder), ``UNet3D`` or ``CostRegNet`` and the heads."""
    p, s = variables["params"], variables.get("batch_stats", {})
    sd = _StateDict()
    fp, fs = p["feature_net"], s.get("feature_net", {})
    if "equi_encoder" in fp:
        sd.encoder("unet.equi_encoder", fp["equi_encoder"],
                   fs["equi_encoder"])
        i = 0
        while f"ConvELU_{i}" in fp:
            sd.conv(f"unet.equi_decoder.{i}.conv.conv",
                    fp[f"ConvELU_{i}"]["Conv_0"])
            i += 1
    elif "Conv_2" in fp:
        sd.erp_tp("unet", fp, fs, (1, 2, 6))
    else:
        sd.single_branch("unet", fp)
    if "reg3dnet" in p:
        rp, rs = p["reg3dnet"], s["reg3dnet"]
        for name in ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5",
                     "conv6", "conv7", "conv9", "conv11"):
            sd.conv(f"unet3d.{name}.conv", rp[name]["WrapConv3D_0"]["Conv_0"])
            sd.batch_norm(f"unet3d.{name}.bn", rp[name]["BatchNorm_0"],
                          rs[name]["BatchNorm_0"])
        sd.conv("unet3d.prob.conv", rp["prob"]["Conv_0"])
    else:
        # UNet3D's blocks in call order: encoders 0..n, then the decoders
        # from the deepest (torch index n-1) to torch index 0
        u3 = p["unet3d"]
        n = (len(u3) - 1) // 2
        for i in range(n + 1):
            sd.conv3d_block(f"unet3d.encoders.{i}", u3[f"Conv3DBlock_{i}"])
        for j in range(n):
            sd.conv3d_block(f"unet3d.decoders.{n - 1 - j}",
                            u3[f"Conv3DBlock_{n + 1 + j}"])
    sd.conv("decoders1.conv", p["decoders1"])
    for i in range(3):
        dp = p[f"decoders2_{i}"]
        sd.conv(f"decoders2.{i}.conv1", dp["WrapConv_0"]["Conv_0"])
        sd.conv(f"decoders2.{i}.conv2", dp["WrapConv_1"]["Conv_0"])
    return dict(sd)


def fnet_state_dict(variables: dict) -> dict:
    """The JAX ``FNetDepthModel``'s variables -> the port's state dict."""
    u = variables["params"]["unet"]
    sd = _StateDict()
    i = 0
    while f"enc{i}" in u:
        sd.conv(f"unet.enc{i}", u[f"enc{i}"]["Conv_0"])
        sd.conv(f"unet.dec{i}.conv1", u[f"dec{i}"]["WrapConv_0"]["Conv_0"])
        sd.conv(f"unet.dec{i}.conv2", u[f"dec{i}"]["WrapConv_1"]["Conv_0"])
        i += 1
    sd.conv("unet.final", u["final"]["Conv_0"])
    return dict(sd)


def uncert_head_state_dict(variables: dict) -> dict:
    """The JAX ``DepthUncertHead``'s variables -> the port's state dict."""
    p = variables["params"]
    sd = _StateDict()
    sd.conv("conv.1", p["WrapConv_0"]["Conv_0"])
    rp = p["ResidualBlock_0"]
    sd.inorm("res.conv.0", rp["InstanceNorm_0"])
    sd.conv("res.conv.3", rp["WrapConv_0"]["Conv_0"])
    sd.inorm("res.conv.4", rp["InstanceNorm_1"])
    sd.conv("res.conv.7", rp["WrapConv_1"]["Conv_0"])
    sd.conv("out", p["Conv_0"])
    return dict(sd)


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Copy a JAX module's variables into the port ``model`` (a gen or ft
    renderer, a mono net, ``MVSDepthModel``, ``FNetDepthModel`` or
    ``DepthUncertHead``; every parameter and buffer must be matched);
    returns the model."""
    converters = ((NeuralRayFtRenderer, ft_renderer_state_dict),
                  (UniFuse, unifuse_state_dict),
                  (ERPTPDepth, unifuse_state_dict),
                  (EquiDepth, equi_depth_state_dict),
                  (CubeDepth, cube_depth_state_dict),
                  (MVSDepthModel, mvs_state_dict),
                  (FNetDepthModel, fnet_state_dict),
                  (DepthUncertHead, uncert_head_state_dict))
    sd = next((fn(params) for cls, fn in converters
               if isinstance(model, cls)), None)
    if sd is None:
        sd = renderer_state_dict(params)
    model.load_state_dict(sd, strict=True)
    return model
