"""Mixture-of-logistics hit-probability decoder.

Port of ``panogrf_tpu/renderer/dist_decoder.py``, with the optional
``vis`` head (``use_vis``; the shipped renderer configs leave it off).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _to_inv(depth: torch.Tensor, near_inv, far_inv) -> torch.Tensor:
    d = torch.clamp(depth, min=1e-5)
    return (-1.0 / d - near_inv) / (far_inv - near_inv)


def get_near_far_intervals_ref(depth: torch.Tensor, interval: torch.Tensor,
                               depth_range: torch.Tensor) -> tuple:
    """Per-sample [near, far) bins in normalized inverse depth: depth
    (qn, rn, dn, rfn), interval (qn, rn, dn), depth_range (rfn, 2)."""
    d = _to_inv(depth, -1.0 / depth_range[:, 0], -1.0 / depth_range[:, 1])
    half = interval / 2.0
    half_ext = torch.cat([half[..., 0:1], half], -1)
    return d - half_ext[..., :-1, None], d + half_ext[..., 1:, None]


def get_near_far_intervals_ref_dm(depth: torch.Tensor,
                                  interval: torch.Tensor,
                                  depth_range: torch.Tensor) -> tuple:
    """Depth-major twin: ``depth`` is (qn, dn, rn, rfn), ``interval`` stays
    (qn, rn, dn)."""
    d = _to_inv(depth, -1.0 / depth_range[:, 0], -1.0 / depth_range[:, 1])
    half = interval / 2.0
    half_ext = torch.cat([half[..., 0:1], half], -1)
    lo = half_ext[..., :-1].transpose(1, 2)
    hi = half_ext[..., 1:].transpose(1, 2)
    return d - lo[..., None], d + hi[..., None]


def get_near_far_intervals_que(depth: torch.Tensor, interval: torch.Tensor,
                               depth_range: torch.Tensor) -> tuple:
    """Query-ray bins from the midpoints between samples; depth and
    interval (qn, rn, dn), depth_range (qn, 2)."""
    d = _to_inv(depth, -1.0 / depth_range[:, 0][:, None, None],
                -1.0 / depth_range[:, 1][:, None, None])
    half = interval / 2.0
    first = d[..., 0] - half[..., 0]
    last = d[..., -1] + half[..., -1]
    mid = (d[..., :-1] + d[..., 1:]) / 2.0
    ext = torch.cat([first[..., None], mid, last[..., None]], -1)
    return ext[..., :-1], ext[..., 1:]


class _MLPHead(nn.Sequential):
    """Linear-ELU-Linear-ELU-Linear head (reference indices 0/2/4); the
    weights are cast to the input's dtype."""

    def __init__(self, din: int, hidden: int, out_dim: int, final: str,
                 bias_val: float = 0.0):
        super().__init__(nn.Linear(din, hidden), nn.ELU(),
                         nn.Linear(hidden, hidden), nn.ELU(),
                         nn.Linear(hidden, out_dim))
        self.final = final
        self.bias_val = bias_val

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def lin(layer, h):
            return F.linear(h, layer.weight.to(x.dtype),
                            layer.bias.to(x.dtype))
        h = F.elu(lin(self[0], x))
        h = F.elu(lin(self[2], h))
        h = lin(self[4], h)
        if self.final == "softplus":
            h = F.softplus(h)
        elif self.final == "sigmoid":
            h = torch.sigmoid(h)
        return h + self.bias_val


class MixtureLogisticsDistDecoder(nn.Module):
    """ray feats (..., F) -> (mean (..., 2), var (..., 2), aw (..., 1));
    with ``use_vis`` a fourth head gives the visibility (..., 1) through
    ``decode_vis``."""

    def __init__(self, feats_dim: int = 32, bias_val: float = 0.05,
                 use_vis: bool = False):
        super().__init__()
        f = feats_dim
        self.mean_decoder = _MLPHead(f, f, 2, "softplus")
        self.var_decoder = _MLPHead(f, f, 2, "softplus", bias_val)
        self.aw_decoder = _MLPHead(f, f, 1, "sigmoid")
        if use_vis:
            self.vis_decoder = _MLPHead(f, f, 1, "sigmoid")

    def forward(self, feats: torch.Tensor) -> tuple:
        return (self.mean_decoder(feats), self.var_decoder(feats),
                self.aw_decoder(feats))

    def decode_vis(self, feats: torch.Tensor) -> torch.Tensor | None:
        """The visibility head's (..., 1), or None without ``use_vis``."""
        return self.vis_decoder(feats) if hasattr(self, "vis_decoder") \
            else None

    def predict_mean(self, feats: torch.Tensor) -> torch.Tensor:
        """Expected-depth head of the depth loss: the mixture means."""
        return self.mean_decoder(feats)


def compute_prob(near: torch.Tensor, far: torch.Tensor, mean: torch.Tensor,
                 var: torch.Tensor, aw: torch.Tensor,
                 vis: torch.Tensor | None = None) -> tuple:
    """Logistic-mixture CDF -> (alpha logit, visibility, hit prob).
    ``near``/``far`` broadcast against ``mean``/``var`` (..., 2) once a
    trailing axis is added; a visibility ``vis`` (..., 1) scales both
    CDFs."""
    mix = torch.cat([aw, 1.0 - aw], -1)
    near = near[..., None]
    far = far[..., None]
    cdf0 = 0.5 + 0.5 * torch.tanh((near - mean) * var)
    cdf1 = 0.5 + 0.5 * torch.tanh((far - mean) * var)
    if vis is not None:
        cdf0 = cdf0 * vis
        cdf1 = cdf1 * vis
    visibility = torch.sum((1.0 - cdf0) * mix, -1)
    hit_prob = torch.sum((cdf1 - cdf0) * mix, -1)
    eps = 1e-5
    alpha = torch.log(hit_prob / (visibility - hit_prob + eps) + eps)
    return alpha, visibility, hit_prob
