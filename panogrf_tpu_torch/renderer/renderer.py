"""Generalizable spherical radiance-field renderer (NeuralRayGenRenderer).

Port of ``panogrf_tpu/renderer/renderer.py``: per-scene encoding
(``prepare_ref``), the coarse + fine passes over a chunk of rays
(deterministic for serving, stochastic with a generator for training), the
light coarse pass (``light_coarse``: importance from the decoded mixture
statistics alone), DINER's depth-guided single pass (``render_rays_diner``,
``sampling_mode="diner"``), perspective query cameras (``perspec_cam``,
cube faces), and the training forward with its depth-loss head and, with
``use_self_hit_prob``, the query view's own hit probabilities of the
consistency loss.  ``ablate`` (measurement only,
``tools/bench.py --ablate``) stands a trivial stage in for one the frame
pays for, so that the frame's time without it attributes its cost:
"gather" fetches every merged-map row from a constant 1x1 map, "agg"
replaces the aggregation net by a reduction of the fetched rows (no
``mlp2`` launch), "agg+gather" does both and "attn" skips the ray
attention; the images are not renders.  ``local_feature_type`` /
``init_net_feature_type``
"ERP+TP" swap the image encoder's and the init net's ``ResUNetLight`` for
the dual ERP + tangent-patch encoder (``nrows``, ``patch_size``), whose
fusion BatchNorms keep their running statistics under training, as in
the JAX package.  Submodule
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
from panogrf_tpu_torch.nn.blocks import (ResUNetLight, init_parameters_,
                                         resize_linear)
from panogrf_tpu_torch.nn.erp_tp import ERPTPEncoder
from panogrf_tpu_torch.ops.resample import interpolate_feats
from panogrf_tpu_torch.renderer import render_ops as ro
from panogrf_tpu_torch.renderer.agg_net import DefaultAggregationNet
from panogrf_tpu_torch.renderer.diner import (project_depth_info,
                                              sample_depthguided)
from panogrf_tpu_torch.renderer.dist_decoder import (
    MixtureLogisticsDistDecoder, compute_prob, get_near_far_intervals_que,
    get_near_far_intervals_ref, get_near_far_intervals_ref_dm)
from panogrf_tpu_torch.renderer.init_net import (CostVolumeInitNet,
                                                 DefaultVisEncoder)
from panogrf_tpu_torch.renderer.sph_solver import depth2normal
from panogrf_tpu_torch.utils.device import resolve_device

# the measurement-only stage ablations (``tools/bench.py --ablate``)
ABLATIONS = ("", "agg", "gather", "agg+gather", "attn")


class NeuralRayGenRenderer(nn.Module):
    """Generalizable renderer; constructor flags as in the JAX package
    (the ``serving``/``turbo``/``exact`` presets' set, the training
    recipe's and the other modes': ``sampling_mode`` "hierarchical" or
    "diner" with its ``diner_*`` counts, ``light_coarse`` with
    ``coarse_proxy_samples``, ``gather_nearest``, ``use_vis``,
    ``render_uncert``, and the encoders' ``local_feature_type`` /
    ``init_net_feature_type`` with ``nrows`` and ``patch_size``, and the
    measurement-only ``ablate``)."""

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
                 use_self_hit_prob: bool = False,
                 use_vis: bool = False, render_uncert: bool = False,
                 light_coarse: bool = False, coarse_proxy_samples: int = 0,
                 gather_nearest: bool = False,
                 sampling_mode: str = "hierarchical",
                 diner_n_candidates: int = 128, diner_n_gaussian: int = 8,
                 diner_n_uniform: int = 0, diner_contain_uniform: int = 0,
                 local_feature_type: str = "ERP",
                 init_net_feature_type: str = "ERP", nrows: int = 4,
                 patch_size: int = 64, ablate: str = "",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
        if sampling_mode not in ("hierarchical", "diner"):
            raise ValueError(f"unknown sampling_mode {sampling_mode!r}")
        if ablate not in ABLATIONS:
            raise ValueError(f"unknown ablate {ablate!r}; choose from "
                             f"{ABLATIONS}")
        super().__init__()
        self.convention = get_convention(convention_name)
        self.height, self.width = height, width
        self.min_depth, self.max_depth = min_depth, max_depth
        self.depth_sample_num = depth_sample_num
        self.fine_depth_sample_num = fine_depth_sample_num
        self.use_hierarchical_sampling = use_hierarchical_sampling
        self.fine_depth_use_all = fine_depth_use_all
        self.use_disp = use_disp
        self.use_self_hit_prob = use_self_hit_prob
        self.compute_dtype = getattr(torch, compute_dtype)
        self.fast_gather = fast_gather
        self.gather_depth_major = gather_depth_major
        self.gather_stride = gather_stride
        self.gather_stride_fine = gather_stride_fine
        self.decode_on_map = decode_on_map
        self.use_vis = use_vis
        self.render_uncert = render_uncert
        self.light_coarse = light_coarse
        self.coarse_proxy_samples = coarse_proxy_samples
        self.gather_nearest = gather_nearest
        self.sampling_mode = sampling_mode
        self.diner_n_candidates = diner_n_candidates
        self.diner_n_gaussian = diner_n_gaussian
        self.diner_n_uniform = diner_n_uniform
        self.diner_contain_uniform = diner_contain_uniform
        self.ablate = ablate

        self.image_encoder = (
            ERPTPEncoder(32, (1, 2, 6), 16, nrows, patch_size)
            if local_feature_type == "ERP+TP"
            else ResUNetLight(32, (1, 2, 6), 16))
        self.init_net = CostVolumeInitNet(depth_hw, mvs_min_depth,
                                          mvs_max_depth,
                                          feature_type=init_net_feature_type,
                                          nrows=nrows, patch_size=patch_size)
        self.vis_encoder = DefaultVisEncoder()
        self.dist_decoder = MixtureLogisticsDistDecoder(use_vis=use_vis)
        attn = ablate == "attn"
        self.agg_net = DefaultAggregationNet(
            geometry_only=coarse_geometry_only and use_hierarchical_sampling,
            ablate_attention=attn)
        if use_hierarchical_sampling:
            self.fine_dist_decoder = MixtureLogisticsDistDecoder(
                use_vis=use_vis)
            self.fine_agg_net = DefaultAggregationNet(ablate_attention=attn)
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
            mixture stats of the coarse head, and of the fine head with
            hierarchical sampling]; with ``light_coarse`` the coarse
            head's stats ``stats_coarse`` (float32, decoded at full
            resolution under ``fast_gather``, else on the ray features'
            own grid).
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
                # decode the mixture heads once on the full-res map; the
                # stats ride on the row each sample fetches anyway
                rf_full = mf_full[..., :ray_feats.shape[-1]].float()
                heads = (self.dist_decoder, self.fine_dist_decoder) \
                    if self.use_hierarchical_sampling else \
                    (self.dist_decoder,)
                for dec in heads:
                    parts.append(self._stats(dec, rf_full).to(dt))
            out["merged_full"] = torch.cat(parts, -1)
        if self.light_coarse:
            if self.fast_gather:
                src = resize_linear(
                    out["merged_feats"][..., :ray_feats.shape[-1]],
                    ref_imgs.shape[1:3], axes=(1, 2)).float()
            else:
                src = ray_feats.float()
            out["stats_coarse"] = self._stats(self.dist_decoder, src)
        return out

    @staticmethod
    def _stats(dec: MixtureLogisticsDistDecoder,
               feats: torch.Tensor) -> torch.Tensor:
        """[mean (2) | var (2) | aw (1) | vis (1, with ``use_vis``)]."""
        vis = dec.decode_vis(feats)
        return torch.cat([*dec(feats)] + ([vis] if vis is not None else []),
                         -1)

    def _points(self, coords, que_depth, que_c2w, perspec_cam) -> tuple:
        """Sample points and negated unit directions of spherical query
        rays, or of a perspective camera ``perspec_cam`` = (w2c (qn, 3, 4),
        K (qn, 3, 3)), whose ray parameter is the z-depth."""
        if perspec_cam is not None:
            return ro.depth2points_perspective(coords, que_depth,
                                               *perspec_cam)
        return ro.depth2points_spherical(coords, que_depth, que_c2w,
                                         self.directions)

    @staticmethod
    def _split_stats(st: torch.Tensor, use_vis: bool) -> tuple:
        """(mean, var, aw, vis or None) of a [mean | var | aw | vis] map."""
        st = st.float()
        vis = st[..., 5:6] if use_vis and st.shape[-1] > 5 else None
        return st[..., 0:2], st[..., 2:4], st[..., 4:5], vis

    # ------------------------------------------------------------------
    # one pass
    # ------------------------------------------------------------------

    def render_by_depth(self, que_depth: torch.Tensor, coords: torch.Tensor,
                        que_c2w: torch.Tensor, que_depth_range: torch.Tensor,
                        ref_data: dict, ref_depth_range: torch.Tensor,
                        is_fine: bool, perspec_cam: tuple | None = None
                        ) -> dict:
        """One rendering pass at given sample depths.

        :param que_depth: (qn, rn, dn); coords (qn, rn, 2); que_c2w (3, 4)
            or, one pose per query, (qn, 3, 4); que_depth_range (qn, 2) or
            (1, 2); ref_depth_range (rfn, 2).
        :param perspec_cam: (w2c (qn, 3, 4), K (qn, 3, 3)) of a
            perspective query camera, which then replaces ``que_c2w``.
        """
        dt = self.compute_dtype
        que_dists = ro.depth2inv_dists(que_depth, que_depth_range)
        que_pts, que_dir = self._points(coords, que_depth, que_c2w,
                                        perspec_cam)
        stride = ((self.gather_stride_fine or self.gather_stride)
                  if is_fine else self.gather_stride)
        # a stride above dn/2 would fetch one row per ray
        stride = max(1, min(stride, que_depth.shape[-1] // 2))
        if "gather" in self.ablate and "merged_full" in ref_data:
            # every row from a constant 1x1 map: the fetch degenerates to
            # a broadcast, the other stages run as they do
            ref_data = dict(ref_data)
            ref_data["merged_full"] = \
                ref_data["merged_full"][:, :1, :1] * 0 + 0.1
        prj = ro.project_points_dict(ref_data, que_pts, self.convention,
                                     que_dir.to(dt),
                                     depth_major=self.gather_depth_major,
                                     gather_stride=stride,
                                     gather_nearest=self.gather_nearest)
        if "stats" in prj:
            # one head's stats, or the coarse then the fine head's
            sw = prj["stats"].shape[-1]
            half = sw // 2 if self.use_hierarchical_sampling else sw
            st = prj["stats"][..., half:] if is_fine \
                else prj["stats"][..., :half]
            mean, var, aw, vis = self._split_stats(st, self.use_vis)
        else:
            decoder = self.fine_dist_decoder if is_fine else \
                self.dist_decoder
            mean, var, aw = decoder(prj["ray_feats"])
            vis = decoder.decode_vis(prj["ray_feats"])
        near_far = (get_near_far_intervals_ref_dm
                    if prj.get("layout") == "dnr"
                    else get_near_far_intervals_ref)
        near, far = near_far(prj["depth"][..., 0], que_dists,
                             ref_depth_range)
        _, visibility, hit_prob = compute_prob(
            near, far, mean.float(), var.float(), aw.float(),
            None if vis is None else vis.float())
        prj["vis"] = visibility[..., None].to(dt)
        prj["hit_prob"] = hit_prob[..., None].to(dt)

        if "agg" in self.ablate:
            # a reduction of the fetched rows in place of the aggregation
            density = torch.sum(prj["hit_prob"][..., 0] + 1e-3 * torch.sum(
                prj["ray_feats"], -1), -1)
            colors = torch.mean(prj["rgb"], -2)
            if prj.get("layout") == "dnr":
                density, colors = density.transpose(1, 2), \
                    colors.transpose(1, 2)
        else:
            agg = self.fine_agg_net if is_fine else self.agg_net
            density, colors = agg(prj)
        density, colors = density.float(), colors.float()
        return self._outputs(que_depth, colors, density,
                             ro.density2outputs(density, colors, que_depth))

    def _outputs(self, que_depth, colors, density, comp) -> dict:
        out = {"pixel_colors_nr": comp["pixel_colors"],
               "hit_prob_nr": comp["hit_prob"], "colors_nr": colors,
               "density_nr": density, "que_depth": que_depth,
               "render_depth": comp["render_depth"]}
        if self.render_uncert:
            d = comp["render_depth"][..., None]
            out["render_uncert"] = torch.sum(
                (que_depth - d) ** 2 * comp["hit_prob"], -1) + 1e-5
        return out

    def coarse_hit_proxy(self, ref_data: dict, que_depth: torch.Tensor,
                         coords: torch.Tensor, que_c2w: torch.Tensor,
                         que_depth_range: torch.Tensor,
                         ref_depth_range: torch.Tensor,
                         perspec_cam: tuple | None = None) -> torch.Tensor:
        """The light coarse pass: (qn, rn, dn) hit probability of the
        per-view mixture statistics ``stats_coarse`` alone (one 5- or
        6-channel fetch and the logistic CDF per sample), averaged over
        the reference views; no aggregation net."""
        que_dists = ro.depth2inv_dists(que_depth, que_depth_range)
        que_pts, _ = self._points(coords, que_depth, que_c2w, perspec_cam)
        prj = ro.project_stats(ref_data, que_pts, self.convention)
        mean, var, aw, vis = self._split_stats(prj["stats"], self.use_vis)
        near, far = get_near_far_intervals_ref(prj["depth"][..., 0],
                                               que_dists, ref_depth_range)
        return torch.mean(compute_prob(near, far, mean, var, aw, vis)[2],
                          -1)

    # ------------------------------------------------------------------
    # coarse + fine
    # ------------------------------------------------------------------

    def _coarse_depth(self, coords: torch.Tensor,
                      generator: torch.Generator | None = None,
                      dn: int | None = None, use_disp: bool | None = None
                      ) -> torch.Tensor:
        qn, rn, _ = coords.shape
        return ro.sample_depth(
            qn, rn, dn or self.depth_sample_num, self.min_depth,
            self.max_depth, self.use_disp if use_disp is None else use_disp,
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
                    fine_samples: int | None = None,
                    perspec_cam: tuple | None = None) -> dict:
        """Coarse (+ fine) rendering of a chunk of rays; fine outputs carry
        a ``_fine`` suffix.  A ``generator`` makes the sampling stochastic
        (training); ``fine_samples`` overrides the fine sample count;
        ``perspec_cam`` renders a perspective camera (``render_by_depth``).
        With ``light_coarse`` (and hierarchical sampling) the coarse pass
        is ``coarse_hit_proxy`` and the outputs are the fine pass's, under
        both key families."""
        args = (que_depth_range, ref_data, ref_depth_range)
        if self.light_coarse and self.use_hierarchical_sampling:
            que_depth = self._coarse_depth(coords, generator,
                                           self.coarse_proxy_samples)
            hit = self.coarse_hit_proxy(ref_data, que_depth, coords,
                                        que_c2w, que_depth_range,
                                        ref_depth_range, perspec_cam)
            fine_depth = self._fine_depth(que_depth, hit, que_depth_range,
                                          generator, fine_samples)
            fine_out = self.render_by_depth(fine_depth, coords, que_c2w,
                                            *args, is_fine=True,
                                            perspec_cam=perspec_cam)
            return {**fine_out,
                    **{k + "_fine": v for k, v in fine_out.items()}}
        que_depth = self._coarse_depth(coords, generator)
        outputs = self.render_by_depth(que_depth, coords, que_c2w, *args,
                                       is_fine=False,
                                       perspec_cam=perspec_cam)
        if self.use_hierarchical_sampling:
            fine_depth = self._fine_depth(
                que_depth, outputs["hit_prob_nr"].detach(), que_depth_range,
                generator, fine_samples)
            if self.fine_depth_use_all:
                fine_depth = torch.sort(torch.cat([que_depth, fine_depth],
                                                  -1), -1).values
            fine_out = self.render_by_depth(fine_depth, coords, que_c2w,
                                            *args, is_fine=True,
                                            perspec_cam=perspec_cam)
            outputs.update({k + "_fine": v for k, v in fine_out.items()})
        return outputs

    def render_rays_diner(self, ref_data: dict, coords: torch.Tensor,
                          que_c2w: torch.Tensor,
                          que_depth_range: torch.Tensor,
                          ref_depth_range: torch.Tensor,
                          n_candidates: int = 128, n_gaussian: int = 8,
                          depth_diff_max: float = 0.05,
                          diner_sigma: float = 0.0,
                          generator: torch.Generator | None = None,
                          backface_culling: bool = False,
                          contain_uniform: int = 0,
                          n_uniform: int = 0) -> dict:
        """DINER's depth-guided rendering of a chunk of rays: one coarse
        pass at ``depth_sample_num`` samples shortlisted from
        ``n_candidates`` uniform ones by the MVS surface likelihood
        (``diner.sample_depthguided``; stochastic with a ``generator``).

        ``ref_data`` also needs ``mvs_depth`` and ``mvs_uncert``
        (rfn, dh, dw, 1).  ``backface_culling`` drops the candidates a
        reference camera sees from behind (normals of its MVS depth).
        ``contain_uniform`` > 0 adds that many uniform samples to the
        guided ones before the pass; ``n_uniform`` > 0 renders that many
        uniform samples in a second coarse pass and composites the sorted
        union of both (``render_ops.merge_composites``).  The outputs
        appear under both key families, as the fine pass's would.
        """
        if "mvs_uncert" not in ref_data:
            raise KeyError("DINER sampling needs ref_data['mvs_uncert']")
        conv = self.convention
        cand = self._coarse_depth(coords, dn=n_candidates, use_disp=False)
        que_pts, que_dir = ro.depth2points_spherical(coords, cand, que_c2w,
                                                     self.directions)
        if backface_culling and "mvs_normal" not in ref_data:
            ref_data = {**ref_data, "mvs_normal": depth2normal(
                ref_data["mvs_depth"], conv)}
        prj = project_depth_info(ref_data, que_pts, conv)
        que_depth = sample_depthguided(
            cand, prj, self.depth_sample_num, n_gaussian, self.min_depth,
            self.max_depth, depth_diff_max, diner_sigma, generator,
            que_dir=que_dir if backface_culling else None,
            w2c=ref_data["w2c"] if backface_culling else None)
        if contain_uniform > 0:
            uni = self._coarse_depth(coords, dn=contain_uniform)
            que_depth = torch.sort(torch.cat([que_depth, uni], -1),
                                   -1).values
        args = (coords, que_c2w, que_depth_range, ref_data, ref_depth_range)
        outputs = self.render_by_depth(que_depth, *args, is_fine=False)
        if n_uniform > 0:
            uni = self._coarse_depth(coords, dn=n_uniform)
            uni_out = self.render_by_depth(uni, *args, is_fine=False)
            z, colors, density, comp = ro.merge_composites(
                outputs["que_depth"], outputs["colors_nr"],
                outputs["density_nr"], uni_out["que_depth"],
                uni_out["colors_nr"], uni_out["density_nr"])
            outputs = self._outputs(z, colors, density, comp)
        return {**outputs, **{k + "_fine": v for k, v in outputs.items()}}

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

    def predict_self_hit_prob(self, que_ray_feats: torch.Tensor,
                              que_depth: torch.Tensor,
                              que_dists: torch.Tensor,
                              que_depth_range: torch.Tensor,
                              is_fine: bool) -> torch.Tensor:
        """The query view's own hit probability at its samples (the
        consistency loss's prediction): the mixture decoded from the query
        ray features (qn, rn, F), evaluated on the bins between the
        samples que_depth (qn, rn, dn).  :return: (qn, rn, dn)."""
        decoder = self.fine_dist_decoder if is_fine else self.dist_decoder
        mean, var, aw = decoder(que_ray_feats)
        vis = decoder.decode_vis(que_ray_feats)
        near, far = get_near_far_intervals_que(que_depth, que_dists,
                                               que_depth_range)
        return compute_prob(near, far, mean[:, :, None], var[:, :, None],
                            aw[:, :, None],
                            None if vis is None else vis[:, :, None])[2]

    def forward(self, data: dict, generator: torch.Generator | None = None,
                fine_samples: int | None = None) -> dict:
        """Train-step forward (the JAX package's ``__call__``): hierarchical
        sampling, or with ``sampling_mode="diner"`` ``render_rays_diner``
        at the ``diner_*`` counts (``mvs_uncert`` from ``ref_imgs_info``,
        0.04 everywhere without it).

        ``data``: ``ref_imgs_info`` with imgs (rfn, H, W, 3), mvs_depth
        (rfn, dh, dw, 1), depth_range (rfn, 2), w2c (rfn, 3, 4) and
        optionally true_depth (rfn, H, W, 1) and mvs_uncert
        (rfn, dh, dw, 1); ``que_imgs_info`` with coords
        (qn, rn, 2), c2w (3, 4), depth_range (qn, 2) and optionally imgs
        (qn, H, W, 3) and, for the consistency loss, mvs_depth
        (qn, dh, dw, 1); optionally ``depth_coords`` (rfn, pn, 2).
        """
        ref_info = data["ref_imgs_info"]
        que_info = data["que_imgs_info"]
        ref_data = self.prepare_ref(ref_info["imgs"], ref_info["mvs_depth"])
        ref_data["w2c"] = ref_info["w2c"]
        coords = que_info["coords"]
        if self.sampling_mode == "diner":
            ref_data["mvs_uncert"] = ref_info.get(
                "mvs_uncert", torch.full_like(ref_info["mvs_depth"], 0.04))
            outputs = self.render_rays_diner(
                ref_data, coords, que_info["c2w"], que_info["depth_range"],
                ref_info["depth_range"], self.diner_n_candidates,
                self.diner_n_gaussian, generator=generator,
                contain_uniform=self.diner_contain_uniform,
                n_uniform=self.diner_n_uniform)
        else:
            outputs = self.render_rays(ref_data, coords, que_info["c2w"],
                                       que_info["depth_range"],
                                       ref_info["depth_range"], generator,
                                       fine_samples)
        if self.use_self_hit_prob and "imgs" in que_info \
                and "mvs_depth" in que_info:
            # the query view encoded as a reference, its ray features
            # sampled at the rays
            que_enc = self.prepare_ref(que_info["imgs"],
                                       que_info["mvs_depth"])
            que_feats = interpolate_feats(que_enc["ray_feats"], coords,
                                          self.height, self.width)
            qdr = que_info["depth_range"]
            passes = (("", False), ("_fine", True)) \
                if self.use_hierarchical_sampling else (("", False),)
            for sfx, fine in passes:
                depth = outputs["que_depth" + sfx]
                outputs["hit_prob_self" + sfx] = self.predict_self_hit_prob(
                    que_feats, depth, ro.depth2inv_dists(depth, qdr), qdr,
                    is_fine=fine)
        if "imgs" in que_info:
            gt = ro.gather_at_coords_batched(que_info["imgs"], coords)
            outputs["pixel_colors_gt"] = gt
            if self.use_hierarchical_sampling or \
                    self.sampling_mode == "diner":
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
