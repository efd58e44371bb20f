"""360-degree MVS depth network (spherical sweep + 3D CNN).

Port of ``panogrf_tpu/models/mvs.py`` for the shipped configuration: the
``Equi`` feature net, MaGNet-style mono-guided depth hypotheses, the
spherical sweep (:mod:`panogrf_tpu_torch.ops.cost_volume`), the ``UNet3D``
regulariser, the 1/4-res aux head ``decoders1`` and the mono-feature
fusion head ``decoders2``.  Parameter names follow the reference layout
``torch_convert.convert_mvs`` reads (``unet.*``, ``unet3d.encoders.{i}``,
``unet3d.decoders.{j}``, ``decoders1.conv``, ``decoders2.{i}.conv{1,2}``).
Channel-last in and out, as in the JAX package.

Not ported yet, and refused: ``use_new_reg3dnet`` (``CostRegNet``), the
ERP+TP / TP / Cube feature nets and ``with_sin``.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.core.sphere import get_convention
from panogrf_tpu_torch.models.unifuse import NUM_CH_DEC, Equi
from panogrf_tpu_torch.nn.blocks import ConvBlock2, UNet3D, resize_linear
from panogrf_tpu_torch.ops.cost_volume import batched_sweep_cost


def magnet_k_list(n_samples: int, sampling_range: float) -> np.ndarray:
    """MaGNet k-list: the probability mass erf(beta/sqrt(2)) split into
    ``n_samples`` equal bins, k = the normal quantiles at bin midpoints."""
    p_total = math.erf(sampling_range / math.sqrt(2.0))
    idx = np.arange(0, n_samples + 1, dtype=np.float64)
    p = (1.0 - p_total) / 2.0 + (idx / n_samples) * p_total
    k = np.asarray([NormalDist().inv_cdf(float(x)) for x in p])
    return ((k[1:] + k[:-1]) / 2.0).astype(np.float32)


def build_depth_hypotheses(ref_mu: torch.Tensor, k_list: Sequence[float],
                           num_total: int, min_depth: float,
                           max_depth: float,
                           sigma: torch.Tensor | float = 0.5,
                           uniform_in_depth: bool = True) -> torch.Tensor:
    """Per-pixel sorted depth hypotheses (B, D, H, W) from the mono depth
    ``ref_mu`` (B, H, W, 1): mu + k sigma (clamped to the depth range)
    beside ``num_total - len(k_list)`` global hypotheses spaced uniformly
    in depth (or inverse depth), sorted along D."""
    mu = ref_mu[..., 0]
    sig = (torch.full_like(mu, float(sigma))
           if isinstance(sigma, (int, float)) else sigma[..., 0])
    ks = torch.as_tensor(np.asarray(k_list, np.float32), device=mu.device)
    mono = torch.clamp(mu[:, None] + ks[None, :, None, None] * sig[:, None],
                       min_depth, max_depth)
    n_uniform = num_total - len(k_list)
    if uniform_in_depth:
        centers = torch.linspace(min_depth, max_depth, n_uniform,
                                 device=mu.device)
    else:
        centers = 1.0 / torch.linspace(1.0 / min_depth, 1.0 / max_depth,
                                       n_uniform, device=mu.device)
    b, _, h, w = mono.shape
    glob = centers[None, :, None, None].expand(b, n_uniform, h, w)
    return torch.sort(torch.cat([mono, glob], 1), 1).values


class MVSDepthModel(nn.Module):
    """Spherical MVS: features -> sweep -> 3D UNet -> depth heads.

    View 0 is the source and view 1 the reference, as in the reference's
    two-view protocol.
    """

    def __init__(self, convention_name: str = "m3d", min_depth: float = 0.1,
                 max_depth: float = 10.0, num_hypotheses: int = 64,
                 magnet_num_samples: int = 5,
                 magnet_sampling_range: float = 3.0,
                 fixed_sigma: float = 0.5, basic_sigma: float = 0.01,
                 uniform_in_depth: bool = True, group_num: int = 1,
                 mvs_uncertainty: bool = False, wrap: bool = True,
                 with_sin: bool = False, wo_mono_feat: bool = False,
                 cnn3d_base: int = 32, use_new_reg3dnet: bool = False,
                 feature_net_type: str = "Equi"):
        super().__init__()
        unported = {"use_new_reg3dnet (CostRegNet)": use_new_reg3dnet,
                    f"feature_net_type {feature_net_type!r}":
                        feature_net_type != "Equi",
                    "with_sin": with_sin}
        for what, asked in unported.items():
            if asked:
                raise NotImplementedError(f"MVSDepthModel {what} is not "
                                          "ported to panogrf_tpu_torch yet")
        self.convention = get_convention(convention_name)
        self.min_depth, self.max_depth = min_depth, max_depth
        self.num_hypotheses = num_hypotheses
        self.magnet_num_samples = magnet_num_samples
        self.magnet_sampling_range = magnet_sampling_range
        self.fixed_sigma, self.basic_sigma = fixed_sigma, basic_sigma
        self.uniform_in_depth = uniform_in_depth
        self.group_num = group_num
        self.mvs_uncertainty = mvs_uncertainty
        self.wo_mono_feat = wo_mono_feat

        feat_ch = NUM_CH_DEC[1]
        d = num_hypotheses
        self.unet = Equi(wrap=wrap)
        # group-wise cost: the mean over each of group_num channel groups
        self.unet3d = UNet3D(group_num if group_num > 1 else feat_ch,
                             cnn3d_base, 3, 1, wrap)
        self.decoders1 = nn.Module()
        self.decoders1.conv = nn.Conv2d(d, 1, 1)
        head_in = d + (0 if wo_mono_feat else feat_ch)
        out_ch = 2 if mvs_uncertainty else 1
        self.decoders2 = nn.ModuleList([
            ConvBlock2(head_in, 32, wrap=wrap, upscale=True, pool=False),
            ConvBlock2(32, 16, wrap=wrap, upscale=True, pool=False),
            ConvBlock2(16, out_ch, wrap=wrap, use_activation=False,
                       pool=False)])

    def forward(self, panos: torch.Tensor, rots: torch.Tensor,
                trans: torch.Tensor, mono_depth: torch.Tensor,
                mono_feat: torch.Tensor | None = None,
                mono_sigma: torch.Tensor | None = None) -> dict:
        """
        :param panos: (B, V, H, W, 3) RGB in [0, 1]; V >= 2, [src, ref, ...].
        :param rots: (B, V, 3, 3) and trans (B, V, 3) world-to-camera.
        :param mono_depth: (B, hm, wm, 1) frozen mono depth of the ref view.
        :param mono_feat: (B, h2, w2, C) frozen mono features of the ref
            view; required unless ``wo_mono_feat``.
        :param mono_sigma: optional (B, hm, wm, 1) mono std.
        :return: dict with ``depth`` (B, H, W, 1), ``rectified_depth_d1``,
            ``cost_reg`` (B, D, H/4, W/4), ``mono_depth_ref``,
            ``depth_volume`` and, with ``mvs_uncertainty``, ``pred_final``
            (B, H, W, 2).
        """
        b, v, h, w, _ = panos.shape
        assert v >= 2
        h4, w4 = h // 4, w // 4
        feats = self.unet(panos.reshape(b * v, h, w, 3))
        cdim = feats.shape[-1]
        feats = feats.reshape(b, v, h4, w4, cdim)
        ref_feats = feats[:, 1]

        mu4 = resize_linear(mono_depth, (h4, w4), axes=(1, 2))
        if self.magnet_num_samples > 0:
            ks = magnet_k_list(self.magnet_num_samples,
                               self.magnet_sampling_range)
            sigma = self.fixed_sigma
            if mono_sigma is not None:
                sigma = torch.clamp(resize_linear(mono_sigma, (h4, w4),
                                                  axes=(1, 2)),
                                    min=self.basic_sigma)
        else:
            ks, sigma = [], self.fixed_sigma
        dvol = build_depth_hypotheses(mu4, ks, self.num_hypotheses,
                                      self.min_depth, self.max_depth, sigma,
                                      self.uniform_in_depth)

        # spherical sweep, averaged over the source views
        srcs = [i for i in range(v) if i != 1]
        cost = sum(batched_sweep_cost(
            ref_feats, feats[:, si], dvol, rots[:, [si, 1]],
            trans[:, [si, 1]], self.convention)
            for si in srcs) / len(srcs)                 # (B, D, H4, W4, C)
        if self.group_num > 1:
            g = self.group_num
            cost = cost.reshape(*cost.shape[:4], g, cdim // g).mean(-1)

        # 3D regularisation over NCDHW
        reg = self.unet3d(cost.permute(0, 4, 1, 2, 3).contiguous())
        cost_reg = reg[:, 0]                             # (B, D, H4, W4)

        d1 = resize_linear(self.decoders1.conv(cost_reg), (h, w),
                           axes=(2, 3))
        rectified_depth_d1 = torch.relu(d1).permute(0, 2, 3, 1)

        head_in = cost_reg
        if not (self.wo_mono_feat or mono_feat is None):
            x_d3 = resize_linear(mono_feat, (h4, w4), axes=(1, 2))
            head_in = torch.cat([cost_reg, x_d3.permute(0, 3, 1, 2)], 1)
        x = head_in
        for block in self.decoders2:
            _, x = block(x)
        x = x.permute(0, 2, 3, 1)
        depth = torch.relu(x[..., :1])
        outputs = {"depth": depth, "rectified_depth_d1": rectified_depth_d1,
                   "cost_reg": cost_reg, "mono_depth_ref": mono_depth,
                   "depth_volume": dvol}
        if self.mvs_uncertainty:
            sigma = F.softplus(x[..., 1:]) + 1e-3
            outputs["pred_final"] = torch.cat([depth, sigma], -1)
        return outputs
