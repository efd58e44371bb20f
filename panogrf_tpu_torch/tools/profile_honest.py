"""Stage-by-stage timing of the per-chunk render pass on one GPU.

    python -m panogrf_tpu_torch.tools.profile_honest [--chunk 2048] \\
        [--dtype bfloat16] [--only gather,agg,...] [--fast-gather] \\
        [--serving] [--device cpu]

Port of the repo's ``tools/profile_honest.py``, with its flags, stages and
JSON keys.  It breaks one chunk of ``--chunk`` rays x 64 samples x 2
reference views of a 512x1024 panorama into stages at the render's
shapes, each on random inputs from seed 0 and random weights:

* ``gather_imgs_512x1024x3_ms``, ``gather_merged_128x256x64_ms``: the
  bilinear fetch of every point from the full-res images and from a
  1/4-res 64-channel map (``ops/resample.interpolate_feats_pointmajor``);
* ``dist_decoder_ms``: the mixture decoder's three heads per point;
* ``compute_prob_ms``: the logistic-mixture CDF;
* ``agg_net_ms``: the aggregation net (prob embed, pooling, ray attention,
  ``out_geometry_fc``, which launches the ``mlp2`` kernel), with the
  direction features computed from the raw directions as the JAX tool's
  net does;
* ``attn_tail_ms``: position table, 4-head ray attention and the
  ``out_geometry_fc`` head (``mlp2``) on pooled (rays, 64, 16) features;
* ``pool_xla_ms``: ``agg_net.pool_reference`` alone, with the JAX tool's
  stack shapes (the name keeps the JAX tool's row);
* ``projection_math_ms``: camera transform and ERP projection;
* ``sample_fine_depth_ms``: the inverse-CDF fine sampling;
* ``coarse_pass_ms``: one ``render_rays`` pass of a 512x1024 renderer
  (coarse only; ``--serving`` at the serving preset's gather flags),
  and ``coarse_pass_frame_equiv_s``, the frame's worth of such passes.

Each stage is iterated on its own output (``_stage_timer``): as one CUDA
graph timed by events, or, where ``<stage>_timing`` says ``events``,
eagerly between CUDA events.  The JSON also carries ``chunk``, ``dtype``,
``device``, ``tf32`` (the caller's flags: the tool leaves them as they
are) and each stage's ``mlp2`` launches per application.  It runs on the
CUDA device and raises without one unless ``--device cpu`` is given (the
host clock; slow at the default sizes).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch import nn

from panogrf_tpu_torch.core.sphere import M3D
from panogrf_tpu_torch.nn.blocks import init_parameters_
from panogrf_tpu_torch.ops.resample import interpolate_feats_pointmajor
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer import render_ops as ro
from panogrf_tpu_torch.renderer.agg_net import (DefaultAggregationNet,
                                                MultiHeadAttention, _Seq,
                                                pool_reference,
                                                sinusoid_pos_encoding)
from panogrf_tpu_torch.renderer.dist_decoder import (
    MixtureLogisticsDistDecoder, compute_prob)
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.tools._stage_timer import (EVENTS, GRAPH, Stage,
                                                  device_name, time_stages,
                                                  tf32_on)
from panogrf_tpu_torch.utils.device import resolve_device

RFN, DN = 2, 64
HW, DEPTH_HW = (512, 1024), (256, 512)
# the JAX tool's pool stacks: name -> [(in, out), ...]
POOL_SHAPES = {"ray_dir_fc": [(4, 16), (16, 35)],
               "neuray_fc": [(32, 8), (8, 1)],
               "base_fc": [(4 * 35 + 35 + 32, 64), (64, 32)],
               "vis_fc": [(32, 32), (32, 33)],
               "vis_fc2": [(32, 32), (32, 1)],
               "geometry_fc": [(65, 64), (64, 16)],
               "rgb_fc": [(37, 16), (16, 8), (8, 1)]}
# stage key -> the name ``--only`` matches against (the JAX tool's)
GROUPS = {"gather_imgs_512x1024x3_ms": "gather",
          "gather_merged_128x256x64_ms": "gather",
          "dist_decoder_ms": "dist_decoder",
          "compute_prob_ms": "compute_prob", "agg_net_ms": "agg",
          "attn_tail_ms": "attn", "pool_xla_ms": "pool",
          "projection_math_ms": "projection",
          "sample_fine_depth_ms": "fine", "coarse_pass_ms": "coarse"}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk", type=int, default=2048)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--only", default="",
                    help="comma-separated stage substrings to run")
    ap.add_argument("--fast-gather", action="store_true")
    ap.add_argument("--serving", action="store_true",
                    help="coarse pass at the serving operating point "
                         "(fast_gather + depth-major + stride 4 + "
                         "decode-on-map)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.serving:
        args.fast_gather = True
    return args


def honest_inputs(chunk: int, hw: tuple = HW, depth_hw: tuple = DEPTH_HW,
                  dn: int = DN) -> dict:
    """The stages' random inputs as numpy, drawn in the JAX tool's order
    (seed 0; the pool stacks from seed 1).  Point coordinates span
    [0, 500 h / 512) as the JAX tool's [0, 500) do at h = 512."""
    h, w = hw
    rng = np.random.default_rng(0)
    n = chunk * dn
    x = {"imgs": rng.uniform(size=(RFN, h, w, 3)),
         "merged": rng.uniform(size=(RFN, h // 4, w // 4, 64)),
         "pts": rng.uniform(0, 500 * h / 512, size=(RFN, n, 2)),
         "feats": rng.normal(size=(1, chunk, dn, RFN, 32)) * 0.3,
         "near": rng.uniform(0, 1, size=(1, chunk, dn, RFN)),
         "mean": rng.uniform(0, 1, size=(1, chunk, dn, RFN, 2)),
         "geo": rng.normal(size=(chunk, dn, 16)) * 0.3}
    prng = np.random.default_rng(1)
    x["pool_params"] = {
        name: [(prng.normal(0, 0.2, (a, b)), prng.normal(0, 0.1, (b,)))
               for a, b in dims] for name, dims in POOL_SHAPES.items()}
    x["rgbf"] = prng.normal(size=(n, RFN, 35))
    x["nray"] = prng.normal(size=(n, RFN, 32))
    x["rdif"] = prng.normal(size=(n, RFN, 4))
    x["pts3"] = rng.normal(size=(n, 3)) * 3
    x["hit"] = rng.uniform(size=(1, chunk, dn))
    x["ref_imgs"] = rng.uniform(size=(RFN, h, w, 3))
    x["mvs_depth"] = rng.uniform(1.0, 6.0, size=(RFN, *depth_hw, 1))
    x["coords"] = np.stack([rng.integers(0, w, (1, chunk)),
                            rng.integers(0, h, (1, chunk))], -1)
    return x


class AttnTail(nn.Module):
    """The post-pool part of the aggregation net: position table, ray
    attention, ``out_geometry_fc`` ((rays, dn, 16) -> (rays, dn, 1))."""

    def __init__(self, dn: int = DN):
        super().__init__()
        self.ray_attention = MultiHeadAttention()
        self.out_geometry_fc = _Seq((16, 16, 1), final_act="relu")
        self.register_buffer("pos", torch.from_numpy(
            sinusoid_pos_encoding(dn, 16)), persistent=False)

    def forward(self, geo: torch.Tensor) -> torch.Tensor:
        x = geo + self.pos.to(geo.dtype)[None]
        return self.out_geometry_fc(self.ray_attention(x))


def dir_diff(dirs: torch.Tensor, que_dir: torch.Tensor) -> torch.Tensor:
    """[dir - que_dir | dir . que_dir] per view (the JAX net's fallback
    for raw directions): dirs (..., rfn, 3), que_dir (..., 3)."""
    q = que_dir[..., None, :]
    return torch.cat([dirs - q, torch.sum(dirs * q, -1, keepdim=True)], -1)


def _seeded(module: nn.Module, dev: torch.device) -> nn.Module:
    init_parameters_(module, torch.Generator().manual_seed(0))
    return module.to(dev).eval()


def honest_stages(chunk: int, dtype: str, dev: torch.device,
                  hw: tuple = HW, depth_hw: tuple = DEPTH_HW,
                  fast_gather: bool = False, serving: bool = False,
                  only=(), dn: int = DN) -> dict:
    """{key: Stage} of the wanted stages (``only``: substrings of the
    stages' group names, all when empty) at ``chunk`` rays of ``dn``
    samples in ``dtype``."""
    h, w = hw
    dt = getattr(torch, dtype)
    x = honest_inputs(chunk, hw, depth_hw, dn)

    def t(a, d=dt):
        return torch.as_tensor(np.asarray(a), dtype=d, device=dev)

    def want(key):
        return not only or any(s in GROUPS[key] for s in only)

    f32 = torch.float32
    stages = {}

    def gather(maps, method=GRAPH):
        def feed(pts, v):
            return (pts + v[..., :2].float().transpose(0, 1) * 1e-6) % h
        return Stage(lambda pts: interpolate_feats_pointmajor(maps, pts, h,
                                                              w),
                     feed, t(x["pts"], f32), method=method)
    if want("gather_imgs_512x1024x3_ms"):
        stages["gather_imgs_512x1024x3_ms"] = gather(t(x["imgs"]))
        # the 1/4-res map's coordinates are rescaled by a host-built
        # factor (``ops/resample._rescale``): a copy no graph can hold
        stages["gather_merged_128x256x64_ms"] = gather(t(x["merged"]),
                                                       EVENTS)

    feats0 = t(x["feats"])
    if want("dist_decoder_ms"):
        dec = _seeded(MixtureLogisticsDistDecoder(), dev)

        def feed_dec(f, o):
            mean, var, aw = o
            upd = (mean.sum(-1, keepdim=True) + var.sum(-1, keepdim=True)
                   + aw)
            return f + (1e-6 * upd).to(f.dtype)
        stages["dist_decoder_ms"] = Stage(dec, feed_dec, feats0, module=dec)

    if want("compute_prob_ms"):
        mean0 = t(x["mean"], f32)
        stages["compute_prob_ms"] = Stage(
            lambda near: compute_prob(near, near + 0.01, mean0, mean0 + 0.5,
                                      mean0[..., :1]),
            lambda near, o: near + 1e-6 * o[2], t(x["near"], f32))

    if want("agg_net_ms"):
        agg = _seeded(DefaultAggregationNet(), dev)
        que_dir = torch.ones(1, chunk, dn, 3, dtype=dt, device=dev)
        prj0 = {"ray_feats": feats0, "rgb": feats0[..., :3],
                "img_feats": feats0, "dir": feats0[..., :3].float(),
                "hit_prob": feats0[..., :1], "vis": feats0[..., :1],
                "alpha": feats0[..., :1]}

        def run_agg(p):
            return agg({**p, "dir_diff": dir_diff(p["dir"],
                                                  que_dir).to(dt)})

        def feed_agg(p, o):
            upd = (1e-6 * o[0][..., None, None]).to(dt)
            return {k: v + upd.to(v.dtype) if v.shape[-1] == 1 else v
                    for k, v in p.items()}
        stages["agg_net_ms"] = Stage(run_agg, feed_agg, prj0, iters=4,
                                     module=agg)

    if want("attn_tail_ms"):
        tail = _seeded(AttnTail(dn), dev)
        stages["attn_tail_ms"] = Stage(
            tail, lambda g, s: g + (1e-6 * s).to(g.dtype), t(x["geo"]),
            module=tail)

    if want("pool_xla_ms"):
        params = {name: [(t(a), t(b)) for a, b in layers]
                  for name, layers in x["pool_params"].items()}
        nray0, rdif0 = t(x["nray"]), t(x["rdif"])
        mask0 = torch.ones(*rdif0.shape[:2], 1, dtype=dt, device=dev)

        def feed_pool(rgbf, o):
            geo, rgb, _ = o
            upd = geo[..., :1] + rgb[..., :1]
            return rgbf + (1e-6 * upd[:, None]).to(rgbf.dtype)
        stages["pool_xla_ms"] = Stage(
            lambda rgbf: pool_reference(rgbf, nray0, rdif0, mask0, params),
            feed_pool, t(x["rgbf"]), iters=4)

    w2c = torch.cat([torch.eye(3), torch.zeros(3, 1)], 1).expand(
        RFN, 3, 4).to(dev)
    if want("projection_math_ms"):
        def project(pts3):
            cam = torch.einsum("vij,pj->pvi", w2c[:, :, :3], pts3) \
                + w2c[None, :, :, 3]
            return M3D.project_to_pixels(cam, h, w)[0]
        stages["projection_math_ms"] = Stage(
            project, lambda p, xy: p + 1e-6 * torch.mean(xy, 1)[..., :2].sum(
                -1, keepdim=True), t(x["pts3"], f32))

    if want("sample_fine_depth_ms"):
        depth0 = torch.linspace(0.5, 15, dn, device=dev).expand(1, chunk, dn)
        hit = t(x["hit"], f32)
        drange = torch.tensor([[0.5, 15.0]], device=dev)
        stages["sample_fine_depth_ms"] = Stage(
            lambda d: ro.sample_fine_depth(d, hit, drange, dn),
            lambda d, f: torch.sort(f, -1).values, depth0.contiguous())

    if want("coarse_pass_ms"):
        model = NeuralRayGenRenderer(
            height=h, width=w, depth_hw=depth_hw, depth_sample_num=dn,
            fine_depth_sample_num=dn, compute_dtype=dtype,
            fast_gather=fast_gather, gather_depth_major=serving,
            gather_stride=4 if serving else 1, decode_on_map=serving,
            use_hierarchical_sampling=False, device=dev,
            generator=torch.Generator().manual_seed(0)).eval()
        dr = torch.tensor([[0.5, 15.0]] * RFN, device=dev)
        ref_data = full_render.prepare_ref_data(
            model, {"imgs": x["ref_imgs"], "mvs_depth": x["mvs_depth"],
                    "w2c": w2c}, device=dev)
        c2w = torch.tensor([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0.5]],
                           device=dev)
        qdr = dr[:1]
        # the per-map gathers rescale coordinates onto the 1/4-res maps by
        # a host-built factor (``ops/resample._rescale``), which no graph
        # can hold; the serving pass fetches full-res rows only
        stages["coarse_pass_ms"] = Stage(
            lambda c: model.render_rays(ref_data, c, c2w, qdr, dr),
            lambda c, o: (c + 1e-6 * o["pixel_colors_nr"][..., :2]) % 128,
            t(x["coords"], f32), iters=4,
            method=GRAPH if fast_gather else EVENTS, module=model)
    return stages


def main(argv=None) -> dict:
    """Profile the stages on ``argv``; prints the JSON and returns it."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    only = [s for s in args.only.split(",") if s]
    res = {"chunk": args.chunk, "dtype": args.dtype}
    with torch.inference_mode():
        stages = honest_stages(args.chunk, args.dtype, dev,
                               fast_gather=args.fast_gather,
                               serving=args.serving, only=only)
        time_stages(stages, dev, res)
    if "coarse_pass_ms" in res:
        res["coarse_pass_frame_equiv_s"] = \
            res["coarse_pass_ms"] * (HW[0] * HW[1] / args.chunk) / 1000.0
    res["device"] = device_name(dev)
    res["tf32"] = tf32_on()
    print(json.dumps(res, indent=1))
    return res


if __name__ == "__main__":
    main()
