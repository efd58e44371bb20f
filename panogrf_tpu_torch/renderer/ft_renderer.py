"""Per-scene finetuning renderer (NeuralRayFtRenderer).

Port of ``panogrf_tpu/renderer/ft_renderer.py``.  The reference views'
ray features are trainable parameters, one ``ray_feats.{i}`` of shape
(1, F, fh, fw) per view (the reference ft checkpoint's layout), first
taken from the generalizable renderer's init net
(``init_ft_params_from_gen``); the image encoder, vis encoder, dist
decoders and aggregation nets keep the gen renderer's names, so its
weights copy over by key and its state dict without ``init_net.*`` plus
the ray features is this module's.  There is no init net: the cached MVS
depth only guides the fine samples, within 3 sigma of it
(``ft_depth_range_at_coords``).  One pass is the gen renderer's own
``render_by_depth``, which reads ``ablate`` (as the JAX ft renderer's, its
aggregation nets keep their ray attention under "attn").
"""

from __future__ import annotations

import torch
from torch import nn

from panogrf_tpu_torch.core.sphere import get_convention
from panogrf_tpu_torch.nn.blocks import ResUNetLight, init_parameters_
from panogrf_tpu_torch.ops.resample import interpolate_feats
from panogrf_tpu_torch.renderer import render_ops as ro
from panogrf_tpu_torch.renderer.agg_net import DefaultAggregationNet
from panogrf_tpu_torch.renderer.dist_decoder import \
    MixtureLogisticsDistDecoder
from panogrf_tpu_torch.renderer.init_net import DefaultVisEncoder
from panogrf_tpu_torch.renderer.renderer import (ABLATIONS,
                                                 NeuralRayGenRenderer)
from panogrf_tpu_torch.renderer.sample_utils import (
    precompute_depth_sampling, sample_3sigma)
from panogrf_tpu_torch.utils.device import resolve_device

# the submodules the ft renderer shares, by name, with the gen renderer
SHARED = ("image_encoder", "vis_encoder", "dist_decoder", "agg_net",
          "fine_dist_decoder", "fine_agg_net")


class NeuralRayFtRenderer(nn.Module):
    """Scene-specialised renderer with trainable per-view ray features."""

    def __init__(self, *, rfn: int = 2, ray_feats_hw: tuple = (64, 128),
                 feat_dim: int = 32, convention_name: str = "m3d",
                 height: int = 512, width: int = 1024,
                 min_depth: float = 0.5, max_depth: float = 15.0,
                 depth_sample_num: int = 64, fine_depth_sample_num: int = 64,
                 use_hierarchical_sampling: bool = True,
                 fine_depth_use_all: bool = False, use_disp: bool = True,
                 ablate: str = "",
                 device: str | torch.device = "cuda",
                 generator: torch.Generator | None = None):
        dev = resolve_device(device)
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
        # read by the borrowed render_by_depth: float32, ray-major rows,
        # every sample fetched (from ray_feats and img_feats: no merged
        # map), bilinear taps, no vis head, no depth spread
        self.compute_dtype = torch.float32
        self.gather_depth_major = False
        self.gather_stride = self.gather_stride_fine = 1
        self.gather_nearest = self.use_vis = self.render_uncert = False
        self.ablate = ablate

        g = generator if generator is not None \
            else torch.Generator().manual_seed(0)
        fh, fw = ray_feats_hw
        self.ray_feats = nn.ParameterList(
            [nn.Parameter(torch.empty(1, feat_dim, fh, fw))
             for _ in range(rfn)])
        self.image_encoder = ResUNetLight(32, (1, 2, 6), 16)
        self.vis_encoder = DefaultVisEncoder(feat_dim)
        self.dist_decoder = MixtureLogisticsDistDecoder(feat_dim)
        self.agg_net = DefaultAggregationNet(feat_dim)
        if use_hierarchical_sampling:
            self.fine_dist_decoder = MixtureLogisticsDistDecoder(feat_dim)
            self.fine_agg_net = DefaultAggregationNet(feat_dim)
        init_parameters_(self, g)
        with torch.no_grad():
            # standard normal features until the gen init net's replace them
            for p in self.ray_feats:
                p.copy_(torch.randn(p.shape, generator=g))
        self.register_buffer(
            "directions", self.convention.ray_directions(height, width),
            persistent=False)
        self.to(dev)

    # one pass at given sample depths: the gen renderer's
    render_by_depth = NeuralRayGenRenderer.render_by_depth
    _points = NeuralRayGenRenderer._points
    _outputs = NeuralRayGenRenderer._outputs

    def ray_feats_maps(self) -> torch.Tensor:
        """The trainable features, channel-last (rfn, fh, fw, F)."""
        return torch.cat([p.permute(0, 2, 3, 1) for p in self.ray_feats])

    def prepare_ref(self, ref_imgs: torch.Tensor) -> dict:
        """Encode the reference views (rfn, H, W, 3): image features and
        the vis encoder applied to the trainable ray features."""
        img_feats = self.image_encoder(ref_imgs)
        ray_feats = self.vis_encoder(self.ray_feats_maps(), img_feats)
        return {"imgs": ref_imgs, "img_feats": img_feats,
                "ray_feats": ray_feats}

    def render_rays(self, ref_data: dict, coords: torch.Tensor,
                    que_c2w: torch.Tensor, que_depth_range: torch.Tensor,
                    ref_depth_range: torch.Tensor,
                    generator: torch.Generator | None = None,
                    ft_depth_range: torch.Tensor | None = None) -> dict:
        """Coarse + fine passes over a chunk of rays; fine outputs carry a
        ``_fine`` suffix.

        :param ft_depth_range: (qn, rn, 3) = (depth, mu - 3 sigma,
            mu + 3 sigma) of the cached MVS depth at the rays: where the
            depth is >= min_depth the fine samples are drawn within 3 sigma
            of it, elsewhere hierarchically.  With a ``generator`` both
            draws use the same uniforms, as the JAX module's one key does.
        """
        qn, rn, _ = coords.shape
        que_depth = ro.sample_depth(qn, rn, self.depth_sample_num,
                                    self.min_depth, self.max_depth,
                                    self.use_disp, coords.device,
                                    generator)[0]
        outputs = self.render_by_depth(que_depth, coords, que_c2w,
                                       que_depth_range, ref_data,
                                       ref_depth_range, is_fine=False)
        if not self.use_hierarchical_sampling:
            return outputs
        fdn = self.fine_depth_sample_num
        u = None if generator is None \
            else ro.uniform(generator, (qn, rn, fdn), coords.device)
        fine_depth = ro.sample_fine_depth(
            que_depth, outputs["hit_prob_nr"].detach(), que_depth_range, fdn,
            inv_mode=self.use_disp, u=u)
        if ft_depth_range is not None:
            guided = sample_3sigma(ft_depth_range[..., 1],
                                   ft_depth_range[..., 2], fdn,
                                   self.min_depth, self.max_depth, u=u)
            valid = (ft_depth_range[..., 0] >= self.min_depth)[..., None]
            fine_depth = torch.where(valid, guided, fine_depth)
        if self.fine_depth_use_all:
            fine_depth = torch.cat([que_depth, fine_depth], -1)
        fine_depth = torch.sort(fine_depth, -1).values
        fine_out = self.render_by_depth(fine_depth, coords, que_c2w,
                                        que_depth_range, ref_data,
                                        ref_depth_range, is_fine=True)
        outputs.update({k + "_fine": v for k, v in fine_out.items()})
        return outputs

    def forward(self, data: dict,
                generator: torch.Generator | None = None) -> dict:
        """Train and render forward.  ``data`` as the gen renderer takes
        it, but ``ref_imgs_info`` needs no mvs_depth; ``que_imgs_info`` may
        hold ``ft_depth_range`` (qn, rn, 3)."""
        ref_info = data["ref_imgs_info"]
        que_info = data["que_imgs_info"]
        ref_data = self.prepare_ref(ref_info["imgs"])
        ref_data["w2c"] = ref_info["w2c"]
        coords = que_info["coords"]
        outputs = self.render_rays(ref_data, coords, que_info["c2w"],
                                   que_info["depth_range"],
                                   ref_info["depth_range"], generator,
                                   que_info.get("ft_depth_range"))
        if "imgs" in que_info:
            outputs["pixel_colors_gt"] = ro.gather_at_coords_batched(
                que_info["imgs"], coords)
        qn, rn, _ = coords.shape
        outputs["ray_mask"] = torch.ones(qn, rn, dtype=torch.bool,
                                         device=coords.device)
        return outputs


@torch.no_grad()
def init_ft_params_from_gen(ft_model: NeuralRayFtRenderer,
                            gen_model: NeuralRayGenRenderer,
                            ref_info: dict) -> dict:
    """Start ``ft_model`` from ``gen_model``: the ray features are the gen
    init net's raw output on the reference views (before the vis encoder,
    which the ft forward applies), the shared submodules' weights copy
    over by name.

    :param ref_info: imgs (rfn, H, W, 3), mvs_depth (rfn, dh, dw, 1) and
        optionally mvs_uncert, on the models' device.
    :return: the cache of ``ft_depth_range_at_coords``: ``mvs_depth`` and,
        when given, ``mvs_uncert``.
    """
    raw = gen_model.init_net(ref_info["imgs"], ref_info["mvs_depth"])
    have = tuple(ft_model.ray_feats_maps().shape)
    if tuple(raw.shape) != have:
        raise ValueError(f"gen init net gives ray features {tuple(raw.shape)}"
                         f", the ft renderer holds {have}")
    for i, p in enumerate(ft_model.ray_feats):
        p.copy_(raw[i].permute(2, 0, 1)[None])
    for name in SHARED:
        if hasattr(gen_model, name) and hasattr(ft_model, name):
            getattr(ft_model, name).load_state_dict(
                getattr(gen_model, name).state_dict())
    cache = {"mvs_depth": ref_info["mvs_depth"]}
    if "mvs_uncert" in ref_info:
        cache["mvs_uncert"] = ref_info["mvs_uncert"]
    return cache


def ft_depth_range_at_coords(cache: dict, view_idx: int,
                             coords: torch.Tensor, height: int, width: int,
                             fixed_sigma: float | None = None
                             ) -> torch.Tensor:
    """Per-ray (depth, mu - 3 sigma, mu + 3 sigma) of depth-guided fine
    sampling: the cached MVS depth of view ``view_idx`` at ``coords``
    (qn, rn, 2) of the (height, width) frame, sigma = ``fixed_sigma``, else
    sqrt of the cached uncertainty, else 10% of the depth.
    :return: (qn, rn, 3).
    """
    d = interpolate_feats(cache["mvs_depth"][view_idx][None], coords,
                          height, width)[..., 0]
    if fixed_sigma is not None:
        std = torch.full_like(d, fixed_sigma)
    elif "mvs_uncert" in cache:
        u = interpolate_feats(cache["mvs_uncert"][view_idx][None], coords,
                              height, width)[..., 0]
        std = torch.sqrt(torch.clamp(u, min=1e-8))
    else:
        std = 0.1 * d
    return precompute_depth_sampling(d, std)
