"""Generalizable spherical radiance-field renderer (NeuralRayGenRenderer).

Frozen from the port's ``renderer/renderer.py``, cut to the serving path
the benchmark's cells drive: per-scene encoding (``prepare_ref``, the
full-res merged map with the decoded mixture statistics of both heads),
the coarse pass's hit probabilities (``coarse_hit_probs``) and the fine
pass they drive (``render_fine_from_hit``), over spherical query rays.
Submodule and parameter names are the port's, so the seeded weights load
by name.

Per chunk: sample_depth -> depth2points -> project into the reference
views and gather -> logistic-mixture probabilities -> aggregation ->
compositing; the fine pass takes inverse-CDF samples of the coarse hit
probabilities.  Under a bfloat16 ``compute_dtype`` the probability and
compositing math stays in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from h100bench.reference.core.sphere import get_convention
from h100bench.reference.nn.blocks import (ResUNetLight, init_parameters_,
                                         resize_linear)
from h100bench.reference.renderer import render_ops as ro
from h100bench.reference.renderer.agg_net import DefaultAggregationNet
from h100bench.reference.renderer.dist_decoder import (
    MixtureLogisticsDistDecoder, compute_prob, get_near_far_intervals_ref_dm)
from h100bench.reference.renderer.init_net import (CostVolumeInitNet,
                                                 DefaultVisEncoder)
from h100bench.reference.utils.device import resolve_device


class NeuralRayGenRenderer(nn.Module):
    """Generalizable renderer with hierarchical sampling; the constructor
    takes the serving flags of the port's (``fast_gather`` with
    ``decode_on_map``, ``gather_depth_major``, the gather strides)."""

    def __init__(self, *, convention_name: str = "m3d", height: int = 512,
                 width: int = 1024, depth_hw: tuple = (256, 512),
                 min_depth: float = 0.5, max_depth: float = 15.0,
                 mvs_min_depth: float = 0.1, mvs_max_depth: float = 10.0,
                 depth_sample_num: int = 64, fine_depth_sample_num: int = 64,
                 use_disp: bool = True, compute_dtype: str = "float32",
                 fast_gather: bool = False, gather_depth_major: bool = False,
                 gather_stride: int = 1, gather_stride_fine: int = 0,
                 decode_on_map: bool = False,
                 coarse_geometry_only: bool = False,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        if not (fast_gather and decode_on_map and gather_depth_major):
            raise ValueError("the frozen renderer has the serving path "
                             "alone: fast_gather, decode_on_map and "
                             "gather_depth_major")
        super().__init__()
        self.convention = get_convention(convention_name)
        self.height, self.width = height, width
        self.min_depth, self.max_depth = min_depth, max_depth
        self.depth_sample_num = depth_sample_num
        self.fine_depth_sample_num = fine_depth_sample_num
        self.use_disp = use_disp
        self.compute_dtype = getattr(torch, compute_dtype)
        self.gather_stride = gather_stride
        self.gather_stride_fine = gather_stride_fine

        self.image_encoder = ResUNetLight(32, (1, 2, 6), 16)
        self.init_net = CostVolumeInitNet(depth_hw, mvs_min_depth,
                                          mvs_max_depth)
        self.vis_encoder = DefaultVisEncoder()
        self.dist_decoder = MixtureLogisticsDistDecoder()
        self.agg_net = DefaultAggregationNet(
            geometry_only=coarse_geometry_only)
        self.fine_dist_decoder = MixtureLogisticsDistDecoder()
        self.fine_agg_net = DefaultAggregationNet()
        init_parameters_(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))
        self.register_buffer(
            "directions", self.convention.ray_directions(height, width),
            persistent=False)
        self.to(dev)

    # ------------------------------------------------------------------
    # per-scene encoding
    # ------------------------------------------------------------------

    def prepare_ref(self, ref_imgs: torch.Tensor,
                    mvs_depth: torch.Tensor) -> dict:
        """Encode the reference views once per scene.

        :param ref_imgs: (rfn, H, W, 3); mvs_depth (rfn, dh, dw, 1).
        :return: dict of channel-last maps: imgs, img_feats, ray_feats,
            merged_feats and the full-res ``merged_full`` [rgb | ray feats
            | img feats | decoded mixture stats of the coarse head, then
            of the fine head].
        """
        img_feats = self.image_encoder(ref_imgs)
        ray_feats = self.vis_encoder(self.init_net(ref_imgs, mvs_depth),
                                     img_feats)
        dt = self.compute_dtype
        out = {"imgs": ref_imgs.to(dt), "img_feats": img_feats.to(dt),
               "ray_feats": ray_feats.to(dt), "mvs_depth": mvs_depth}
        rf_up = resize_linear(out["ray_feats"], img_feats.shape[1:3],
                              axes=(1, 2))
        out["merged_feats"] = torch.cat([rf_up, out["img_feats"]], -1)
        mf_full = resize_linear(out["merged_feats"], ref_imgs.shape[1:3],
                                axes=(1, 2))
        parts = [out["imgs"], mf_full.to(dt)]
        # decode the mixture heads once on the full-res map; the stats
        # ride on the row each sample fetches anyway
        rf_full = mf_full[..., :ray_feats.shape[-1]].float()
        for dec in (self.dist_decoder, self.fine_dist_decoder):
            parts.append(torch.cat([*dec(rf_full)], -1).to(dt))
        out["merged_full"] = torch.cat(parts, -1)
        return out

    # ------------------------------------------------------------------
    # one pass
    # ------------------------------------------------------------------

    def render_by_depth(self, que_depth: torch.Tensor, coords: torch.Tensor,
                        que_c2w: torch.Tensor, que_depth_range: torch.Tensor,
                        ref_data: dict, ref_depth_range: torch.Tensor,
                        is_fine: bool) -> dict:
        """One rendering pass at given sample depths.

        :param que_depth: (qn, rn, dn); coords (qn, rn, 2); que_c2w (3, 4)
            or, one pose per query, (qn, 3, 4); que_depth_range (qn, 2) or
            (1, 2); ref_depth_range (rfn, 2).
        """
        dt = self.compute_dtype
        que_dists = ro.depth2inv_dists(que_depth, que_depth_range)
        que_pts, que_dir = ro.depth2points_spherical(
            coords, que_depth, que_c2w, self.directions)
        stride = ((self.gather_stride_fine or self.gather_stride)
                  if is_fine else self.gather_stride)
        # a stride above dn/2 would fetch one row per ray
        stride = max(1, min(stride, que_depth.shape[-1] // 2))
        prj = ro.project_points_dict(ref_data, que_pts, self.convention,
                                     que_dir.to(dt), gather_stride=stride)
        # the coarse then the fine head's stats
        half = prj["stats"].shape[-1] // 2
        st = (prj["stats"][..., half:] if is_fine
              else prj["stats"][..., :half]).float()
        mean, var, aw = st[..., 0:2], st[..., 2:4], st[..., 4:5]
        near, far = get_near_far_intervals_ref_dm(prj["depth"][..., 0],
                                                  que_dists, ref_depth_range)
        _, visibility, hit_prob = compute_prob(near, far, mean, var, aw)
        prj["vis"] = visibility[..., None].to(dt)
        prj["hit_prob"] = hit_prob[..., None].to(dt)
        agg = self.fine_agg_net if is_fine else self.agg_net
        density, colors = agg(prj)
        density, colors = density.float(), colors.float()
        comp = ro.density2outputs(density, colors, que_depth)
        return {"pixel_colors_nr": comp["pixel_colors"],
                "hit_prob_nr": comp["hit_prob"], "colors_nr": colors,
                "density_nr": density, "que_depth": que_depth,
                "render_depth": comp["render_depth"]}

    # ------------------------------------------------------------------
    # coarse + fine
    # ------------------------------------------------------------------

    def _coarse_depth(self, coords: torch.Tensor) -> torch.Tensor:
        qn, rn, _ = coords.shape
        return ro.sample_depth(qn, rn, self.depth_sample_num, self.min_depth,
                               self.max_depth, self.use_disp,
                               coords.device)[0]

    def coarse_hit_probs(self, ref_data: dict, coords: torch.Tensor,
                         que_c2w: torch.Tensor, que_depth_range: torch.Tensor,
                         ref_depth_range: torch.Tensor) -> torch.Tensor:
        """Coarse importance only: (qn, rn, dn) ``hit_prob_nr``.  Every ray
        has the same deterministic depth ticks, so a low-res grid of these
        can be upsampled to drive the full-res fine pass."""
        return self.render_by_depth(self._coarse_depth(coords), coords,
                                    que_c2w, que_depth_range, ref_data,
                                    ref_depth_range,
                                    is_fine=False)["hit_prob_nr"]

    def render_fine_from_hit(self, ref_data: dict, coords: torch.Tensor,
                             hit_prob: torch.Tensor, que_c2w: torch.Tensor,
                             que_depth_range: torch.Tensor,
                             ref_depth_range: torch.Tensor) -> dict:
        """Fine pass driven by an externally supplied coarse importance
        (evenly spaced u through the inverse CDF: sorted samples)."""
        fine_depth = ro.sample_fine_depth(
            self._coarse_depth(coords), hit_prob, que_depth_range,
            self.fine_depth_sample_num, inv_mode=self.use_disp)
        fine_out = self.render_by_depth(fine_depth, coords, que_c2w,
                                        que_depth_range, ref_data,
                                        ref_depth_range, is_fine=True)
        return {**fine_out, **{k + "_fine": v for k, v in fine_out.items()}}
