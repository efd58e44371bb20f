"""Depth-guided sampling utilities (3-sigma and quadratic schedules).

Port of ``panogrf_tpu/renderer/sample_utils.py``: inverse-CDF sampling
from per-bin weights (``sample_pdf``), Gaussian 3-sigma samples around a
cached depth prior (``sample_3sigma``), stratified jitter
(``perturb_z_vals``), the depth +- 3 sigma precompute of the ft renderer
and the quadratic depth schedule.  Every random draw goes through
``render_ops.uniform``, as the renderer's other sampling does.
"""

from __future__ import annotations

import math

import torch

from panogrf_tpu_torch.renderer import render_ops as ro


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               generator: torch.Generator | None = None,
               u: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse-CDF sampling from per-bin weights, at u = linspace(0, 1, n),
    at random u from ``generator``, or at given draws ``u``.

    The bin of each u is found by counting the CDF entries <= u and both
    ends are gathered, as in the JAX package (not ``sample_fine_depth``'s
    summation form).
    :param bins: (..., nb) bin edges; weights (..., nb - 1).
    :return: (..., n_samples) samples.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, -1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    shape = (*cdf.shape[:-1], n_samples)
    if u is None and generator is None:
        u = torch.linspace(0.0, 1.0, n_samples, device=cdf.device) \
            .expand(shape)
    elif u is None:
        u = ro.uniform(generator, shape, cdf.device)
    inds = torch.sum((cdf[..., None, :] <= u[..., :, None]).int(), -1)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    nb = bins.shape[-1]
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bin_b = torch.gather(bins, -1, torch.clamp(below, max=nb - 1))
    bin_a = torch.gather(bins, -1, torch.clamp(above, max=nb - 1))
    denom = torch.where(cdf_a - cdf_b < 1e-5, torch.ones_like(cdf_a),
                        cdf_a - cdf_b)
    t = (u - cdf_b) / denom
    return bin_b + t * (bin_a - bin_b)


def sample_3sigma(low: torch.Tensor, high: torch.Tensor, n: int,
                  near: float, far: float,
                  generator: torch.Generator | None = None,
                  u: torch.Tensor | None = None) -> torch.Tensor:
    """n depths from a Gaussian spanning [low, high] = mu -+ 3 sigma, the
    edges clamped to [near, far].

    :param low: (...,) lower and ``high`` upper 3-sigma bounds.
    :return: (..., n).
    """
    t = torch.linspace(0.0, 1.0, n, device=low.device)
    step = (high - low) / (n - 1)
    edges = torch.clamp(low[..., None] * (1 - t) + high[..., None] * t,
                        near, far)
    factor = (edges[..., 1:] - edges[..., :-1]) \
        / torch.clamp(step[..., None], min=1e-8)
    x = torch.linspace(-3.0, 3.0, n - 1, device=low.device)
    gauss = (1.0 / math.sqrt(2 * math.pi)) * torch.exp(-0.5 * x ** 2)
    return sample_pdf(edges, factor * gauss, n, generator, u)


def perturb_z_vals(z_vals: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """Stratified jitter of each sample within its bin between the
    midpoints to its neighbours."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    t = ro.uniform(generator, tuple(z_vals.shape), z_vals.device)
    return lower + (upper - lower) * t


def precompute_depth_sampling(depth: torch.Tensor,
                              std: torch.Tensor) -> torch.Tensor:
    """(depth, depth - 3 std, depth + 3 std) stacked on the last axis."""
    return torch.stack([depth, depth - 3.0 * std, depth + 3.0 * std], -1)


def precompute_quadratic_samples(near: float, far: float,
                                 num_samples: int) -> torch.Tensor:
    """Quadratic depth schedule from ``near`` to ``far``."""
    start = 0.1
    x = torch.linspace(0.0, 1.0, num_samples)
    a = (far - near) / (1.0 + 2.0 * start)
    b = 2.0 * start * a
    return a * x ** 2 + b * x + near
