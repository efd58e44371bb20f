"""Carry renderer parameters between the JAX package and the port.

``renderer_state_dict`` is the inverse of
``panogrf_tpu/utils/torch_convert.convert_renderer``: the JAX
``NeuralRayGenRenderer``'s ``params`` tree (a nested dict of numpy arrays)
becomes a state dict in the reference PyTorch layout, which the port's
modules use.  Conv kernels (kH, kW, I, O) become (O, I, kH, kW), Dense
kernels (in, out) become Linear weights (out, in), and GroupNorm
``scale``/``bias`` become the instance norms' ``weight``/``bias``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_POOL_STACKS = ("ray_dir_fc", "neuray_fc", "base_fc", "vis_fc", "vis_fc2",
                "geometry_fc", "rgb_fc")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _StateDict(dict):
    def conv(self, key: str, p: dict) -> None:
        self[f"{key}.weight"] = _t(np.transpose(p["kernel"], (3, 2, 0, 1)))
        if "bias" in p:
            self[f"{key}.bias"] = _t(p["bias"])

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

    def resunet(self, prefix: str, p: dict, layers) -> None:
        self.conv(f"{prefix}.conv1.1", p["Conv_0"])
        self.inorm(f"{prefix}.bn1", p["InstanceNorm_0"])
        blk = 0
        for li, nblocks in enumerate(layers, start=1):
            for bi in range(nblocks):
                t, bp = f"{prefix}.layer{li}.{bi}", p[f"BasicBlock_{blk}"]
                self.conv(f"{t}.conv1.1", bp["WrapConv_0"]["Conv_0"])
                self.inorm(f"{t}.bn1", bp["InstanceNorm_0"])
                self.conv(f"{t}.conv2.1", bp["WrapConv_1"]["Conv_0"])
                self.inorm(f"{t}.bn2", bp["InstanceNorm_1"])
                if "Conv_0" in bp:
                    self.conv(f"{t}.downsample.0", bp["Conv_0"])
                    self.inorm(f"{t}.downsample.1", bp["InstanceNorm_2"])
                blk += 1
        self.conv_in_elu(f"{prefix}.upconv3.conv",
                         p["UpconvINELU_0"]["ConvINELU_0"])
        self.conv_in_elu(f"{prefix}.iconv3", p["ConvINELU_0"])
        self.conv_in_elu(f"{prefix}.upconv2.conv",
                         p["UpconvINELU_1"]["ConvINELU_0"])
        self.conv_in_elu(f"{prefix}.iconv2", p["ConvINELU_1"])
        self.conv(f"{prefix}.out_conv", p["Conv_1"])

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


def renderer_state_dict(params: dict) -> dict:
    """The JAX ``NeuralRayGenRenderer``'s params (with or without the outer
    ``{"params": ...}``) -> reference-layout state dict of CPU tensors."""
    p = params.get("params", params)
    sd = _StateDict()
    sd.resunet("image_encoder", p["image_encoder"], (1, 2, 6))
    sd.resunet("init_net.res_net", p["init_net"]["res_net"], (2, 3, 6))
    sd.conv_res_conv("init_net.depth_conv", p["init_net"]["depth_conv"], 1)
    sd.conv_res_conv("init_net.out_conv", p["init_net"]["out_conv"], 1)
    sd.conv_res_conv("vis_encoder.out_conv", p["vis_encoder"], 2)
    # the fine modules exist only with hierarchical sampling
    for name in ("dist_decoder", "fine_dist_decoder"):
        if name in p:
            sd.dist_decoder(name, p[name])
    for name in ("agg_net", "fine_agg_net"):
        if name in p:
            sd.agg_net(name, p[name])
    return dict(sd)


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Copy the JAX renderer's parameters into the port ``model`` (every
    parameter must be matched); returns the model."""
    sd = renderer_state_dict(params)
    model.load_state_dict(sd, strict=True)
    return model
