"""IBRNet-with-NeuRay aggregation network.

Port of ``panogrf_tpu/renderer/agg_net.py``.  Per (ray, sample) the net
pools appearance features across reference views, runs a 4-head attention
along the samples of each ray and emits density and view-blended RGB.
Module and parameter names follow the reference PyTorch layout
(``prob_embed.0``, ``agg_impl.base_fc.0``, ``agg_impl.ray_attention.w_qs``,
...).  ``_Seq`` is where the ``mlp2`` CUDA kernel enters the path.
``ablate_attention`` (measurement only, ``tools/bench.py --ablate attn``)
passes the pooled features by the ray attention, whose parameters stay.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.ops.kernels.fused_mlp import mlp2_batched


def sinusoid_pos_encoding(n_samples: int, d_hid: int) -> np.ndarray:
    """Classic transformer position table, (n_samples, d_hid) float32."""
    pos = np.arange(n_samples)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_samples, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)


def _linears(seq: nn.Sequential, dtype: torch.dtype) -> list:
    """The Linear layers of ``seq`` as (W (in, out), b) in ``dtype``."""
    return [(m.weight.t().to(dtype), m.bias.to(dtype))
            for m in seq if isinstance(m, nn.Linear)]


class MultiHeadAttention(nn.Module):
    """Post-LN self-attention; q, k and v come from one fused projection."""

    def __init__(self, n_head: int = 4, d_model: int = 16, d_k: int = 4,
                 d_v: int = 4):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """x (b, l, d_model); mask (b, l, 1) masks query rows."""
        b, lq, _ = x.shape
        dt = x.dtype
        wqkv = torch.cat([self.w_qs.weight, self.w_ks.weight,
                          self.w_vs.weight], 0).to(dt)
        y = F.linear(x, wqkv)
        nk = self.n_head * self.d_k
        qh = y[..., :nk].reshape(b, lq, self.n_head, self.d_k).transpose(1, 2)
        kh = y[..., nk:2 * nk].reshape(b, lq, self.n_head, self.d_k) \
            .transpose(1, 2)
        vh = y[..., 2 * nk:].reshape(b, lq, self.n_head, self.d_v) \
            .transpose(1, 2)
        attn = (qh / (self.d_k ** 0.5)) @ kh.transpose(-1, -2)
        if mask is not None:
            attn = torch.where(mask[:, None] == 0,
                               torch.full_like(attn, -1e9), attn)
        attn = torch.softmax(attn, -1)
        out = (attn @ vh.to(attn.dtype)).to(dt)
        out = out.transpose(1, 2).reshape(b, lq, -1)
        out = F.linear(out, self.fc.weight.to(dt)) + x
        return F.layer_norm(out, out.shape[-1:],
                            self.layer_norm.weight.to(dt),
                            self.layer_norm.bias.to(dt), 1e-6)


def pool_reference(rgb_feat: torch.Tensor, neuray_feat: torch.Tensor,
                   ray_diff: torch.Tensor, mask: torch.Tensor, p: dict,
                   geometry_only: bool = False) -> tuple:
    """Per-sample cross-view pooling up to the ray attention.

    :param rgb_feat: (N, v, F); neuray_feat (N, v, 32); ray_diff (N, v, 4);
        mask (N, v, 1); ``p`` maps each stack name to its [(W, b), ...]
        with W laid out (in, out).
    :return: (geo (N, 16), rgb (N, 3), num_valid (N, 1)).
    """
    eps = 1e-8

    def seq2(name, x, act_last=True):
        (w0, b0), (w1, b1) = p[name]
        h = _elu(x @ w0 + b0) @ w1 + b1
        return _elu(h) if act_last else h

    def mean_var(x, wt):
        m = torch.sum(x * wt, 1, keepdim=True)
        return m, torch.sum(wt * (x - m) ** 2, 1, keepdim=True)

    weight = mask / (torch.sum(mask, 1, keepdim=True) + eps)
    rgbf = rgb_feat + seq2("ray_dir_fc", ray_diff)
    w0 = torch.sigmoid(seq2("neuray_fc", neuray_feat, False)) * weight
    mean0, var0 = mean_var(rgbf, w0)
    mean1, var1 = mean_var(rgbf, weight)
    # base_fc layer 0 over [mean0|var0|mean1|var1 | rgbf | neuray]: the
    # per-point segments meet the top row block of its weight once per
    # point instead of once per view
    f = rgbf.shape[-1]
    (bw0, bb0), (bw1, bb1) = p["base_fc"]
    gf = torch.cat([mean0[:, 0], var0[:, 0], mean1[:, 0], var1[:, 0]], -1)
    xv = torch.cat([rgbf, neuray_feat], -1)
    h = _elu((gf @ bw0[:4 * f])[:, None] + xv @ bw0[4 * f:] + bb0)
    x = _elu(h @ bw1 + bb1)

    hv = seq2("vis_fc", x * weight)
    x_res, vis = hv[..., :-1], hv[..., -1:]
    vis = torch.sigmoid(vis) * mask
    x = x + x_res
    (vw0, vb0), (vw1, vb1) = p["vis_fc2"]
    h2 = _elu((x * vis) @ vw0 + vb0)
    vis = torch.sigmoid(h2 @ vw1 + vb1) * mask
    wgt = vis / (torch.sum(vis, 1, keepdim=True) + eps)

    mean, var = mean_var(x, wgt)
    geo = seq2("geometry_fc",
               torch.cat([mean[:, 0], var[:, 0], torch.mean(wgt, 1)], -1))
    nvalid = torch.sum(mask[..., 0], 1, keepdim=True)
    if geometry_only:
        # the serving coarse pass discards its blended RGB
        return geo, torch.zeros(geo.shape[0], 3, dtype=geo.dtype,
                                device=geo.device), nvalid

    (rw0, rb0), (rw1, rb1), (rw2, rb2) = p["rgb_fc"]
    h = _elu(torch.cat([x, vis, ray_diff], -1) @ rw0 + rb0)
    logit = _elu(h @ rw1 + rb1) @ rw2 + rb2
    logit = torch.where(mask == 0, torch.full_like(logit, -1e9), logit)
    blend = torch.softmax(logit, 1)
    return geo, torch.sum(rgb_feat[..., :3] * blend, 1), nvalid


class _Seq(nn.Sequential):
    """Linear stack with ELU between layers and ``final_act`` after the
    last (reference Sequential indices 0/2/...).

    The pool stacks are parameter holders that ``pool_reference`` reads;
    only 2-layer stacks are called.  Their forward is the dispatch point
    of the ``mlp2`` kernel: ``mlp2`` launches it for a CUDA tensor and
    computes the JAX package's plain ``_Seq`` path for a CPU tensor.
    """

    def __init__(self, dims: tuple, final_act: str = "elu"):
        layers = []
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            layers += [nn.Linear(a, b)] + ([nn.ELU()] if i < len(dims) - 2
                                           else [])
        super().__init__(*layers)
        self.final_act = final_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (w1, b1), (w2, b2) = _linears(self, x.dtype)
        return mlp2_batched(x, w1.contiguous(), b1, w2.contiguous(), b2,
                            act1="elu", act2=self.final_act)


_POOL_DIMS = {  # name -> layer widths, given F = in_feat_ch + 3, nd
    "ray_dir_fc": lambda f, nd: (4, 16, f),
    "base_fc": lambda f, nd: (5 * f + nd, 64, 32),
    "vis_fc": lambda f, nd: (32, 32, 33),
    "vis_fc2": lambda f, nd: (32, 32, 1),
    "geometry_fc": lambda f, nd: (65, 64, 16),
    "neuray_fc": lambda f, nd: (nd, 8, 1),
    "rgb_fc": lambda f, nd: (37, 16, 8, 1),
}


class IBRNetWithNeuRay(nn.Module):
    """(rgb_feat, neuray_feat, ray_diff, mask) -> (nr, dn, 4) rgb+sigma.

    Inputs are (nr, dn, v, c) ray-major, or (qn*dn, rn, v, c) depth-major
    with ``dnr_dims = (qn, dn, rn)``; only the pooled 16/3/1-channel
    outputs are transposed to ray-major for the attention.
    """

    def __init__(self, neuray_in_dim: int = 32, in_feat_ch: int = 32,
                 geometry_only: bool = False, ablate_attention: bool = False):
        super().__init__()
        self.geometry_only = geometry_only
        self.ablate_attention = ablate_attention
        f = in_feat_ch + 3
        for name, dims in _POOL_DIMS.items():
            self.add_module(name, _Seq(dims(f, neuray_in_dim)))
        self.ray_attention = MultiHeadAttention()
        self.out_geometry_fc = _Seq((16, 16, 1), final_act="relu")
        self._pos = {}          # (dn, device, dtype) -> position table

    def _pos_encoding(self, dn: int, like: torch.Tensor) -> torch.Tensor:
        """The (dn, 16) position table for the pass's sample count (it
        changes with ``fine_depth_use_all`` and count-jitter training)."""
        key = (dn, like.device, like.dtype)
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(
                sinusoid_pos_encoding(dn, 16)).to(like.device, like.dtype)
        return self._pos[key]

    def forward(self, rgb_feat, neuray_feat, ray_diff, mask,
                dnr_dims: tuple | None = None) -> torch.Tensor:
        a0, a1, v, _ = rgb_feat.shape
        if dnr_dims is not None:
            qn, dn, rn = dnr_dims
            nr = qn * rn
        else:
            nr, dn = a0, a1
        dt = rgb_feat.dtype
        params = {name: _linears(getattr(self, name), dt)
                  for name in _POOL_DIMS}

        def flat(t):
            return t.reshape(a0 * a1, v, t.shape[-1])

        geo, rgb_out, nvalid = pool_reference(
            flat(rgb_feat), flat(neuray_feat), flat(ray_diff), flat(mask),
            params, self.geometry_only)
        if dnr_dims is not None:
            def to_ray_major(t):
                c = t.shape[-1]
                return t.reshape(qn, dn, rn, c).transpose(1, 2) \
                    .reshape(nr, dn, c)
            geo = to_ray_major(geo).to(dt)
            rgb_out = to_ray_major(rgb_out)
            num_valid_obs = to_ray_major(nvalid).float()
        else:
            geo = geo.reshape(nr, dn, 16).to(dt)
            rgb_out = rgb_out.reshape(nr, dn, 3)
            num_valid_obs = nvalid.reshape(nr, dn, 1).float()
        globalfeat = geo + self._pos_encoding(dn, geo)[None]
        attn_mask = (num_valid_obs[..., 0] > 1).to(dt)
        if not self.ablate_attention:
            globalfeat = self.ray_attention(globalfeat, attn_mask[..., None])
        sigma = self.out_geometry_fc(globalfeat).float()
        sigma = torch.where(num_valid_obs < 1, torch.zeros_like(sigma), sigma)
        return torch.cat([rgb_out.float(), sigma], -1)


class DefaultAggregationNet(nn.Module):
    """prob-embed + dir-diff + IBRNetWithNeuRay."""

    def __init__(self, neuray_dim: int = 32, in_feat_ch: int = 32,
                 geometry_only: bool = False, ablate_attention: bool = False):
        super().__init__()
        self.prob_embed = nn.Sequential(nn.Linear(neuray_dim + 2, neuray_dim),
                                        nn.ReLU(),
                                        nn.Linear(neuray_dim, neuray_dim))
        self.agg_impl = IBRNetWithNeuRay(neuray_dim, in_feat_ch,
                                         geometry_only, ablate_attention)

    def forward(self, prj_dict: dict) -> tuple:
        """
        :param prj_dict: per-view projections (qn, rn, dn, rfn, .):
            ``hit_prob``, ``vis``, ``rgb``, ``ray_feats``, ``img_feats``,
            ``dir_diff`` — depth-major (qn, dn, rn, rfn, .) when
            ``prj_dict['layout'] == 'dnr'``.
        :return: (density (qn, rn, dn), colors (qn, rn, dn, 3)).
        """
        hit_prob = (prj_dict["hit_prob"] - 0.5) * 2.0
        vis = (prj_dict["vis"] - 0.5) * 2.0
        dnr = prj_dict.get("layout") == "dnr"
        if dnr:
            qn, dn, rn, rfn, _ = hit_prob.shape
        else:
            qn, rn, dn, rfn, _ = hit_prob.shape
        dt = hit_prob.dtype
        (k0, b0), (k1, b1) = _linears(self.prob_embed, dt)
        raw = torch.cat([prj_dict["ray_feats"], hit_prob, vis], -1)
        prob_embedding = torch.relu(raw @ k0 + b0) @ k1 + b1

        def to_rays(t):
            if dnr:   # (qn, dn, rn, rfn, c) -> (qn*dn, rn, rfn, c)
                return t.reshape(qn * dn, rn, rfn, t.shape[-1])
            return t.reshape(qn * rn, dn, rfn, t.shape[-1])

        img_feats = torch.cat([prj_dict["rgb"], prj_dict["img_feats"]], -1)
        mask = torch.ones(*hit_prob.shape[:-1], 1, dtype=img_feats.dtype,
                          device=img_feats.device)
        out = self.agg_impl(to_rays(img_feats), to_rays(prob_embedding),
                            to_rays(prj_dict["dir_diff"]), to_rays(mask),
                            dnr_dims=(qn, dn, rn) if dnr else None)
        return out[..., 3].reshape(qn, rn, dn), \
            out[..., :3].reshape(qn, rn, dn, 3)
