"""Generalizable spherical radiance-field renderer (NeuralRayGenRenderer).

Port of ``panogrf_tpu/renderer/renderer.py``'s hierarchical mode:
per-scene encoding (``prepare_ref``), the coarse + fine passes over a
chunk of rays (deterministic for serving, stochastic with a generator for
training) and the training forward with its depth-loss head.  Submodule
and parameter names follow the reference PyTorch state dict, so
``load_state_dict`` takes a reference renderer checkpoint and
``utils.from_jax.load_jax_params`` takes the JAX package's parameter tree.

Per chunk: sample_depth -> depth2points -> project into the reference
views and gather -> logistic-mixture probabilities -> aggregation ->
compositing; then inverse-CDF fine samples and a second pass.  Under a
bfloat16 ``compute_dtype`` the probability and compositing math stays in
float32.
"""

from __future__ import annotations

import torch
from torch import nn

from panogrf_tpu_torch.core.sphere import get_convention
from panogrf_tpu_torch.nn.blocks import ResUNetLight, resize_linear
from panogrf_tpu_torch.ops.resample import interpolate_feats
from panogrf_tpu_torch.renderer import render_ops as ro
from panogrf_tpu_torch.renderer.agg_net import DefaultAggregationNet
from panogrf_tpu_torch.renderer.dist_decoder import (
    MixtureLogisticsDistDecoder, compute_prob, get_near_far_intervals_ref,
    get_near_far_intervals_ref_dm)
from panogrf_tpu_torch.renderer.init_net import (CostVolumeInitNet,
                                                 DefaultVisEncoder)
from panogrf_tpu_torch.utils.device import resolve_device


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: LeCun-normal weights, unit norm scales and
    zero biases (the JAX package's initialisers, untruncated)."""
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            fan_in = p[0].numel()
            p.copy_(torch.randn(p.shape, generator=generator)
                    / fan_in ** 0.5)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()


class NeuralRayGenRenderer(nn.Module):
    """Generalizable renderer; constructor flags as in the JAX package
    (the ``serving``/``turbo``/``exact`` presets' set and the training
    recipe's)."""

    def __init__(self, *, convention_name: str = "m3d", height: int = 512,
                 width: int = 1024, depth_hw: tuple = (256, 512),
                 min_depth: float = 0.5, max_depth: float = 15.0,
                 mvs_min_depth: float = 0.1, mvs_max_depth: float = 10.0,
                 depth_sample_num: int = 64, fine_depth_sample_num: int = 64,
                 use_hierarchical_sampling: bool = True,
                 fine_depth_use_all: bool = False,
                 use_disp: bool = True, compute_dtype: str = "float32",
                 fast_gather: bool = False, gather_depth_major: bool = False,
                 gather_stride: int = 1, gather_stride_fine: int = 0,
                 decode_on_map: bool = False,
                 coarse_geometry_only: bool = False,
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        super().__init__()
        self.convention = get_convention(convention_name)
        self.height, self.width = height, width
        self.min_depth, self.max_depth = min_depth, max_depth
        self.depth_sample_num = depth_sample_num
        self.fine_depth_sample_num = fine_depth_sample_num
        self.use_hierarchical_sampling = use_hierarchical_sampling
        self.fine_depth_use_all = fine_depth_use_all
        self.use_disp = use_disp
        self.compute_dtype = getattr(torch, compute_dtype)
        self.fast_gather = fast_gather
        self.gather_depth_major = gather_depth_major
        self.gather_stride = gather_stride
        self.gather_stride_fine = gather_stride_fine
        self.decode_on_map = decode_on_map

        self.image_encoder = ResUNetLight(32, (1, 2, 6), 16)
        self.init_net = CostVolumeInitNet(depth_hw, mvs_min_depth,
                                          mvs_max_depth)
        self.vis_encoder = DefaultVisEncoder()
        self.dist_decoder = MixtureLogisticsDistDecoder()
        self.agg_net = DefaultAggregationNet(
            geometry_only=coarse_geometry_only and use_hierarchical_sampling)
        if use_hierarchical_sampling:
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
            merged_feats and, with ``fast_gather``, the full-res
            ``merged_full`` [rgb | ray feats | img feats | decoded
            coarse + fine mixture stats].
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
        if self.fast_gather:
            mf_full = resize_linear(out["merged_feats"], ref_imgs.shape[1:3],
                                    axes=(1, 2))
            parts = [out["imgs"], mf_full.to(dt)]
            if self.decode_on_map:
                # decode both mixture heads once on the full-res map; the
                # stats ride on the row each sample fetches anyway
                rf_full = mf_full[..., :ray_feats.shape[-1]].float()
                for dec in (self.dist_decoder, self.fine_dist_decoder):
                    parts.append(torch.cat(dec(rf_full), -1).to(dt))
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

        :param que_depth: (qn, rn, dn); coords (qn, rn, 2); que_c2w (3, 4);
            que_depth_range (qn, 2); ref_depth_range (rfn, 2).
        """
        dt = self.compute_dtype
        que_dists = ro.depth2inv_dists(que_depth, que_depth_range)
        que_pts, que_dir = ro.depth2points_spherical(coords, que_depth,
                                                     que_c2w, self.directions)
        stride = ((self.gather_stride_fine or self.gather_stride)
                  if is_fine else self.gather_stride)
        # a stride above dn/2 would fetch one row per ray
        stride = max(1, min(stride, que_depth.shape[-1] // 2))
        prj = ro.project_points_dict(ref_data, que_pts, self.convention,
                                     que_dir.to(dt),
                                     depth_major=self.gather_depth_major,
                                     gather_stride=stride)
        if "stats" in prj:
            half = prj["stats"].shape[-1] // 2
            st = prj["stats"][..., half:] if is_fine \
                else prj["stats"][..., :half]
            st = st.float()
            mean, var, aw = st[..., 0:2], st[..., 2:4], st[..., 4:5]
        else:
            decoder = self.fine_dist_decoder if is_fine else \
                self.dist_decoder
            mean, var, aw = decoder(prj["ray_feats"])
        near_far = (get_near_far_intervals_ref_dm
                    if prj.get("layout") == "dnr"
                    else get_near_far_intervals_ref)
        near, far = near_far(prj["depth"][..., 0], que_dists,
                             ref_depth_range)
        _, visibility, hit_prob = compute_prob(near, far, mean.float(),
                                               var.float(), aw.float())
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

    def _coarse_depth(self, coords: torch.Tensor,
                      generator: torch.Generator | None = None
                      ) -> torch.Tensor:
        qn, rn, _ = coords.shape
        return ro.sample_depth(qn, rn, self.depth_sample_num, self.min_depth,
                               self.max_depth, self.use_disp,
                               coords.device, generator)[0]

    def _fine_depth(self, que_depth, hit_prob, que_depth_range,
                    generator: torch.Generator | None = None,
                    fine_samples: int | None = None) -> torch.Tensor:
        fine_depth = ro.sample_fine_depth(
            que_depth, hit_prob, que_depth_range,
            fine_samples or self.fine_depth_sample_num,
            inv_mode=self.use_disp, generator=generator)
        # evenly spaced u through the monotone inverse CDF come out sorted;
        # random u do not
        return fine_depth if generator is None \
            else torch.sort(fine_depth, -1).values

    def render_rays(self, ref_data: dict, coords: torch.Tensor,
                    que_c2w: torch.Tensor, que_depth_range: torch.Tensor,
                    ref_depth_range: torch.Tensor,
                    generator: torch.Generator | None = None,
                    fine_samples: int | None = None) -> dict:
        """Coarse (+ fine) rendering of a chunk of rays; fine outputs carry
        a ``_fine`` suffix.  A ``generator`` makes the sampling stochastic
        (training); ``fine_samples`` overrides the fine sample count."""
        que_depth = self._coarse_depth(coords, generator)
        outputs = self.render_by_depth(que_depth, coords, que_c2w,
                                       que_depth_range, ref_data,
                                       ref_depth_range, is_fine=False)
        if self.use_hierarchical_sampling:
            fine_depth = self._fine_depth(
                que_depth, outputs["hit_prob_nr"].detach(), que_depth_range,
                generator, fine_samples)
            if self.fine_depth_use_all:
                fine_depth = torch.sort(torch.cat([que_depth, fine_depth],
                                                  -1), -1).values
            fine_out = self.render_by_depth(fine_depth, coords, que_c2w,
                                            que_depth_range, ref_data,
                                            ref_depth_range, is_fine=True)
            outputs.update({k + "_fine": v for k, v in fine_out.items()})
        return outputs

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
        """Fine pass driven by an externally supplied coarse importance."""
        fine_depth = self._fine_depth(self._coarse_depth(coords), hit_prob,
                                      que_depth_range)
        fine_out = self.render_by_depth(fine_depth, coords, que_c2w,
                                        que_depth_range, ref_data,
                                        ref_depth_range, is_fine=True)
        return {**fine_out, **{k + "_fine": v for k, v in fine_out.items()}}

    # ------------------------------------------------------------------
    # training forward
    # ------------------------------------------------------------------

    def predict_mean_for_depth_loss(self, ray_feats: torch.Tensor,
                                    coords: torch.Tensor) -> dict:
        """Mixture means decoded from ray features sampled at (rfn, pn, 2)
        full-res coords (the depth loss's prediction)."""
        feats = interpolate_feats(ray_feats, coords, self.height, self.width)
        mean = self.dist_decoder.predict_mean(feats)
        out = {"depth_mean": mean[..., 0], "depth_mean_2": mean[..., 1]}
        if self.use_hierarchical_sampling:
            mean_f = self.fine_dist_decoder.predict_mean(feats)
            out["depth_mean_fine"] = mean_f[..., 0]
            out["depth_mean_fine_2"] = mean_f[..., 1]
        return out

    def forward(self, data: dict, generator: torch.Generator | None = None,
                fine_samples: int | None = None) -> dict:
        """Train-step forward (the JAX package's ``__call__``, hierarchical
        mode).

        ``data``: ``ref_imgs_info`` with imgs (rfn, H, W, 3), mvs_depth
        (rfn, dh, dw, 1), depth_range (rfn, 2), w2c (rfn, 3, 4) and
        optionally true_depth (rfn, H, W, 1); ``que_imgs_info`` with coords
        (qn, rn, 2), c2w (3, 4), depth_range (qn, 2) and optionally imgs
        (qn, H, W, 3); optionally ``depth_coords`` (rfn, pn, 2).
        """
        ref_info = data["ref_imgs_info"]
        que_info = data["que_imgs_info"]
        ref_data = self.prepare_ref(ref_info["imgs"], ref_info["mvs_depth"])
        ref_data["w2c"] = ref_info["w2c"]
        coords = que_info["coords"]
        outputs = self.render_rays(ref_data, coords, que_info["c2w"],
                                   que_info["depth_range"],
                                   ref_info["depth_range"], generator,
                                   fine_samples)
        if "imgs" in que_info:
            gt = ro.gather_at_coords_batched(que_info["imgs"], coords)
            outputs["pixel_colors_gt"] = gt
            if self.use_hierarchical_sampling:
                outputs["pixel_colors_gt_fine"] = gt
        qn, rn, _ = coords.shape
        # every projection is valid on the sphere
        outputs["ray_mask"] = torch.ones(qn, rn, dtype=torch.bool,
                                         device=coords.device)
        # per-ray sin(phi) weight of the polar-weighted render loss
        outputs["polar_weights"] = torch.sin(
            (coords[..., 1] + 0.5) * torch.pi / self.height)
        if "true_depth" in ref_info:
            depth_coords = data.get("depth_coords")
            if depth_coords is None:
                rfn = ref_info["imgs"].shape[0]
                depth_coords = coords[0][None].expand(rfn, rn, 2)
            outputs["depth_coords"] = depth_coords
            outputs.update(self.predict_mean_for_depth_loss(
                ref_data["ray_feats"], depth_coords))
        return outputs
