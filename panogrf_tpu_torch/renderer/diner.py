"""DINER occlusion-aware depth-guided ray sampling.

Port of ``panogrf_tpu/renderer/diner.py``: project ``n_candidates``
uniform samples into every reference view, score each by the Gaussian
(mu_mvs, sigma_mvs) surface likelihood, shortlist the top ``n_samples`` per
ray, replace the tail with Gaussian draws around the likelihood-weighted
depth and fill the zero-likelihood slots uniformly; optionally discard the
candidates a reference camera sees from behind (backface culling).

The Gaussian draws and the fill jitter come from an explicit CPU
``torch.Generator`` (``render_ops.normal`` / ``render_ops.uniform``), or
are passed in as tensors (``noise``, ``jitter``); without either the
sampler is deterministic (no tail noise, mid-stratum fill).
"""

from __future__ import annotations

import math

import torch

from panogrf_tpu_torch.core.sphere import SphereConvention
from panogrf_tpu_torch.ops.resample import interpolate_feats
from panogrf_tpu_torch.renderer import render_ops as ro


def project_depth_info(ref_data: dict, que_pts: torch.Tensor,
                       convention: SphereConvention) -> dict:
    """Each candidate's MVS depth statistics in every reference view.

    ``ref_data``: mvs_depth (rfn, dh, dw, 1), mvs_uncert (rfn, dh, dw, 1),
    w2c (rfn, 3, 4), imgs (rfn, H, W, 3) for the pixel frame and, for
    backface culling, mvs_normal (rfn, dh, dw, 3).
    :param que_pts: (qn, rn, cn, 3) world candidate points.
    :return: ``mu``, ``uncert``, ``depth`` (rfn, qn, rn, cn) and, with
        normals, ``normal`` (rfn, qn, rn, cn, 3).
    """
    qn, rn, cn, _ = que_pts.shape
    rfn, h, w, _ = ref_data["imgs"].shape
    w2c = ref_data["w2c"]
    cam = torch.einsum("vij,pj->vpi", w2c[:, :, :3],
                       que_pts.reshape(-1, 3)) + w2c[:, None, :, 3]
    xy, depth = convention.project_to_pixels(cam, h, w)
    shape = (rfn, qn, rn, cn)
    out = {"mu": interpolate_feats(ref_data["mvs_depth"], xy, h, w)[..., 0],
           "uncert": interpolate_feats(ref_data["mvs_uncert"], xy, h,
                                       w)[..., 0],
           "depth": depth}
    out = {k: v.reshape(shape) for k, v in out.items()}
    if "mvs_normal" in ref_data:
        out["normal"] = interpolate_feats(ref_data["mvs_normal"], xy, h,
                                          w).reshape(*shape, 3)
    return out


def fill_uniform(z: torch.Tensor, near: float, far: float,
                 generator: torch.Generator | None = None,
                 jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Fill the zero slots of ``z`` (..., n) with stratified uniform depths
    over [near, far] (one stratum per missing slot, at ``jitter`` within
    it: given, drawn from ``generator``, or 0.5); returns sorted depths."""
    z = torch.sort(z, -1).values                     # zeros first
    missing = z == 0.0
    n_missing = torch.sum(missing, -1, keepdim=True)
    step = (far - near) / torch.clamp(n_missing, min=1).to(z.dtype)
    idx = torch.arange(z.shape[-1], dtype=z.dtype, device=z.device)
    if jitter is None:
        jitter = ro.uniform(generator, z.shape, z.device) \
            if generator is not None else torch.full_like(z, 0.5)
    z_fill = near + idx * step + jitter.to(z.dtype) * step
    return torch.sort(torch.where(missing, z_fill, z), -1).values


def _view_terms(que_depth: torch.Tensor, prj: dict, near: float,
                far: float, fixed_sigma: float, que_dir, w2c) -> tuple:
    """Per view and candidate: the Gaussian bin mass of the MVS surface at
    the candidate (unmasked), |mu - depth|, and with normals the cosine
    between the forward ray and the surface normal (else None)."""
    mu, d = prj["mu"], prj["depth"]
    sigma = torch.full_like(mu, fixed_sigma) if fixed_sigma > 0 \
        else torch.sqrt(torch.clamp(prj["uncert"], min=1e-8))
    step = (far - near) / que_depth.shape[-1]
    denom = sigma * math.sqrt(2.0)
    lik = 0.5 * torch.abs(torch.special.erf((d + step / 2 - mu) / denom)
                          - torch.special.erf((d - step / 2 - mu) / denom))
    cosd = None
    if "normal" in prj and que_dir is not None and w2c is not None:
        # the forward ray direction (-que_dir) in each reference frame
        fwd_cam = torch.einsum("vij,qrcj->vqrci", w2c[:, :, :3], -que_dir)
        cosd = torch.sum(fwd_cam * prj["normal"], -1)
    return lik, torch.abs(mu - d), cosd


def surface_likelihood(que_depth: torch.Tensor, prj: dict, near: float,
                       far: float, depth_diff_max: float = 0.05,
                       fixed_sigma: float = 0.0, que_dir=None,
                       w2c=None) -> torch.Tensor:
    """(qn, rn, cn) likelihood of a surface at each candidate: the largest
    over the reference views of the Gaussian bin mass, 0 where the MVS
    depth is ``depth_diff_max`` or more away (or the surface faces away)."""
    lik, dist, cosd = _view_terms(que_depth, prj, near, far, fixed_sigma,
                                  que_dir, w2c)
    valid = dist < depth_diff_max
    if cosd is not None:
        valid = valid & (cosd <= 0.0)
    return torch.amax(torch.where(valid, lik, torch.zeros_like(lik)), 0)


def sample_depthguided(que_depth: torch.Tensor, prj: dict, n_samples: int,
                       n_gaussian: int, near: float, far: float,
                       depth_diff_max: float = 0.05,
                       fixed_sigma: float = 0.0,
                       generator: torch.Generator | None = None,
                       que_dir: torch.Tensor | None = None,
                       w2c: torch.Tensor | None = None,
                       noise: torch.Tensor | None = None,
                       jitter: torch.Tensor | None = None) -> torch.Tensor:
    """Shortlist candidate depths by the occlusion-aware surface
    likelihood.

    :param que_depth: (qn, rn, cn) sorted uniform candidate depths.
    :param prj: ``project_depth_info``'s output.
    :param que_dir: (qn, rn, cn, 3) negated unit ray directions; with
        ``prj["normal"]`` and ``w2c`` (rfn, 3, 4) the candidates seen from
        behind are discarded.
    :param noise: (qn, rn, n_gaussian) standard-normal draws of the tail;
        ``jitter`` (qn, rn, n_samples) the fill's uniform draws.  Either
        is drawn from ``generator`` when not given (noise first).
    :return: (qn, rn, n_samples) sorted depths, the gaps filled.
    """
    pt_lik = surface_likelihood(que_depth, prj, near, far, depth_diff_max,
                                fixed_sigma, que_dir, w2c)
    # the shortlist ranks by the likelihood itself; the transmittance-
    # weighted ``opaque`` only shapes the Gaussian tail's moments
    opaque = torch.cat([pt_lik[..., :1], pt_lik[..., 1:] * torch.cumprod(
        1.0 - pt_lik, -1)[..., :-1]], -1)
    top_lik, top_idx = torch.topk(pt_lik, n_samples, -1)
    z_sel = torch.gather(que_depth, -1, top_idx)
    z_sel = torch.where(top_lik == 0.0, torch.zeros_like(z_sel), z_sel)
    if n_gaussian > 0:
        w = opaque + 1e-12
        wsum = torch.sum(w, -1, keepdim=True)
        mean = torch.sum(que_depth * w, -1, keepdim=True) / wsum
        var = torch.sum((que_depth - mean) ** 2 * w, -1, keepdim=True) / wsum
        std = torch.sqrt(torch.clamp(var, min=1e-10))
        any_lik = torch.any(opaque != 0.0, -1, keepdim=True)
        shape = (*que_depth.shape[:-1], n_gaussian)
        if noise is None:
            noise = ro.normal(generator, shape, que_depth.device) \
                if generator is not None else torch.zeros(
                    shape, device=que_depth.device)
        gauss = torch.where(any_lik, noise.to(std.dtype) * std + mean,
                            torch.zeros_like(mean))
        z_sel = torch.cat([z_sel[..., :-n_gaussian], gauss], -1)
    # a negative draw clamps to 0 and is refilled as a missing slot
    return fill_uniform(torch.clamp(z_sel, 0.0, far), near, far, generator,
                        jitter)


def ambiguous_rays(que_depth: torch.Tensor, prj: dict, n_samples: int,
                   n_gaussian: int, near: float, far: float,
                   depth_diff_max: float = 0.05, fixed_sigma: float = 0.0,
                   que_dir=None, w2c=None, tol: float = 1e-4
                   ) -> torch.Tensor:
    """(qn, rn) rays whose DINER samples float rounding may change:
    evaluated on float64 inputs, a ray is flagged when a candidate's
    validity is within ``tol`` of flipping (|mu - depth| at
    ``depth_diff_max``, a backface cosine at 0) while its bin mass is not
    negligible, when a valid candidate's bin mass is below ``tol`` (a
    float32 evaluation may give 0), or when the likelihoods on either side
    of the kept shortlist's boundary (rank ``n_samples - n_gaussian``)
    differ by less than ``tol``.  Every other ray selects the same
    candidates in any float32 evaluation."""
    lik, dist, cosd = _view_terms(que_depth, prj, near, far, fixed_sigma,
                                  que_dir, w2c)
    valid = dist < depth_diff_max
    near_flip = torch.abs(dist - depth_diff_max) < tol
    if cosd is not None:
        valid = valid & (cosd <= 0.0)
        near_flip = near_flip | ((torch.abs(cosd) < tol)
                                 & (dist < depth_diff_max + tol))
    flag = torch.any((near_flip & (lik >= tol)) | (valid & (lik < tol)),
                     0).any(-1)
    pt = torch.amax(torch.where(valid, lik, torch.zeros_like(lik)), 0)
    k = n_samples - n_gaussian if n_gaussian > 0 else n_samples
    if k < pt.shape[-1]:
        srt = torch.sort(pt, -1, descending=True).values
        flag = flag | ((srt[..., k - 1] > 0)
                       & (srt[..., k - 1] - srt[..., k] < tol))
    return flag
