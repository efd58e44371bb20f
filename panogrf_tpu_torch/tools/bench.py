"""Headline benchmark: a novel 512x1024 panorama rendered on one GPU.

    python -m panogrf_tpu_torch.tools.bench [--preset serving|turbo|exact] \\
        [--chunk C] [--coarse-chunk C] [--diner] [--light-coarse] \\
        [--video-batch B] [--with-depth-stack] [--no-roofline] \\
        [--ablate agg|gather|agg+gather|attn] [--device cpu]

Port of the repo's ``bench.py``, with its flags, inputs and presets.  It
renders the frame of ``bench.py``'s inputs (two random reference views,
depth given, random weights from seed 0) through
``full_render.render_image_device`` and prints ONE JSON line: ``metric``,
``value`` (the median ms/frame of 3 runs after a warm-up, timed with CUDA
events), ``unit``, ``runs`` and their ``spread``, ``rays_per_sec`` and
``vs_baseline`` (null: the JAX tool's 1.0 s/frame baseline was set for
another chip), the ``mlp2`` kernel's launches in one frame and its
cross-view pools and ray attentions by path (``pool_fused_launches``,
``pool_plain_launches``, ``attn_fused_launches``, ``attn_plain_launches``),
and the device's name.  The default run also times the turbo point
(``turbo_ms_per_frame``); ``--video-batch B`` times B poses per pass
(``render_video_device``, ``video_ms_per_frame``); ``--with-depth-stack``
times the per-scene cost, the frozen UniFuse + MVS stack and
``prepare_ref`` (``scene_prep_ms``).  Unless ``--no-roofline``, ``--diner``
or ``--ablate``, the aggregation and the merged-map fetch are iterated
alone at the run's chunk and priced by ``utils/roofline.py`` against the
card's peaks (``agg_ms``, ``agg_mfu``, ``gather_ms``, ...).  ``--ablate``
stands a trivial stage in for one (the renderer's ``ablate``, measurement
only).

It runs on the CUDA device and raises without one unless ``--device cpu``
is given; on the CPU it renders 64x128 in float32 (a smoke run: no
fraction of the card's peaks is reported).  ``--video-batch`` with
``--diner`` or ``--light-coarse`` is refused: the video path renders the
hierarchical passes only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from panogrf_tpu_torch.core.sphere import get_convention
from panogrf_tpu_torch.models.depth_stack import init_depth_stack
from panogrf_tpu_torch.nn.blocks import init_parameters_
from panogrf_tpu_torch.ops.kernels import fused_mlp
from panogrf_tpu_torch.ops.resample import interpolate_feats_pointmajor
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer import render_ops as ro
from panogrf_tpu_torch.renderer.agg_net import DefaultAggregationNet
from panogrf_tpu_torch.renderer.presets import (PRESET_CHUNK,
                                                PRESET_COARSE_CHUNK,
                                                PRESET_COARSE_LOWRES,
                                                preset_kwargs)
from panogrf_tpu_torch.renderer.renderer import (ABLATIONS,
                                                 NeuralRayGenRenderer)
from panogrf_tpu_torch.tools._stage_timer import time_chain
from panogrf_tpu_torch.utils import roofline as rl
from panogrf_tpu_torch.utils.device import resolve_device, synchronize

RFN = 2
# (H, W, depth H, depth W) of the frame by device type
SIZES = {"cuda": (512, 1024, 256, 512), "cpu": (64, 128, 32, 64)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # flags given explicitly override the preset's
    ap.add_argument("--preset", default="serving",
                    choices=["exact", "serving", "turbo"])
    ap.add_argument("--chunk", type=int, default=None)
    ap.add_argument("--coarse-chunk", type=int, default=None,
                    help="ray-chunk size of the low-res coarse pass alone "
                         "(default: the preset's; 0 = --chunk)")
    ap.add_argument("--no-fast-gather", dest="fast_gather",
                    action="store_false", default=None)
    ap.add_argument("--diner", action="store_true",
                    help="depth-guided (DINER) sampling: 64 guided samples, "
                         "no fine pass")
    ap.add_argument("--light-coarse", action="store_true",
                    help="the proxy coarse pass (importance from the decoded "
                         "mixture statistics)")
    ap.add_argument("--proxy-samples", type=int, default=0,
                    help="coarse sample count of the proxy pass (0 = "
                         "depth_sample_num)")
    ap.add_argument("--no-depth-major", dest="depth_major",
                    action="store_false", default=None,
                    help="fetch rows in (ray, sample) order")
    ap.add_argument("--gather-stride", type=int, default=None,
                    help="fetch merged-map rows at every S-th sample and "
                         "lerp the rows between")
    ap.add_argument("--gather-stride-fine", type=int, default=None,
                    help="the fine pass's stride (0 = --gather-stride)")
    ap.add_argument("--gather-nearest", action="store_true", default=None,
                    help="fetch the nearest row instead of the 2x2 window")
    ap.add_argument("--coarse-lowres", type=int, default=None,
                    help="run the coarse pass on an (H/f, W/f) ray grid "
                         "(default: the preset's f)")
    ap.add_argument("--no-decode-on-map", dest="decode_on_map",
                    action="store_false", default=None,
                    help="per-sample dist-decoder MLPs instead of the "
                         "statistics fetched with the row")
    ap.add_argument("--fine-samples", type=int, default=0,
                    help="fine-pass sample count (0 = the preset's)")
    ap.add_argument("--coarse-samples", type=int, default=0,
                    help="coarse-pass sample count (0 = 64)")
    ap.add_argument("--video-batch", type=int, default=0,
                    help="also time B poses per pass "
                         "(render_video_device): video_ms_per_frame")
    ap.add_argument("--no-coarse-geometry-only", dest="coarse_geo_only",
                    action="store_false", default=None,
                    help="keep the coarse pass's RGB head")
    ap.add_argument("--with-depth-stack", action="store_true",
                    help="also time the per-scene cost: the frozen depth "
                         "stack and prepare_ref (scene_prep_ms)")
    ap.add_argument("--no-roofline", dest="roofline", action="store_false",
                    default=True, help="skip the stages' roofline")
    ap.add_argument("--ablate", default="", choices=list(ABLATIONS),
                    help="measurement only: a trivial stand-in for the "
                         "aggregation, the row fetch or the ray attention "
                         "(the image is not a render)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.video_batch and (args.diner or args.light_coarse):
        ap.error("--video-batch renders the hierarchical passes only; it "
                 "takes neither --diner nor --light-coarse")
    return args


def bench_inputs(h: int, w: int, dh: int, dw: int) -> tuple:
    """bench.py's inputs: (ref_info, query c2w (3, 4), query depth range
    (1, 2)) as numpy."""
    rng = np.random.default_rng(0)
    w2c = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], 1),
                  (RFN, 1, 1))
    w2c[1, 2, 3] = 1.0
    ref_info = {"imgs": rng.uniform(size=(RFN, h, w, 3)),
                "mvs_depth": rng.uniform(1.0, 6.0, size=(RFN, dh, dw, 1)),
                "depth_range": np.asarray([[0.5, 15.0]] * RFN),
                "w2c": w2c}
    c2w = np.concatenate([np.eye(3), [[0.0], [0.0], [0.5]]], 1)
    return ref_info, c2w, np.asarray([[0.5, 15.0]])


def timed_runs(fn, dev: torch.device, runs: int = 3,
               warmup: bool = True) -> list:
    """ms of ``fn(i)`` for i in 0..runs-1, after a warm-up ``fn(0)`` unless
    the caller has warmed it: CUDA events on the card, the host clock on
    the CPU."""
    if warmup:
        fn(0)
    times = []
    for i in range(runs):
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(i)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn(i)
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def counted(fn) -> dict:
    """The mlp2 / mlp3 launches of one call of ``fn``, by variant."""
    fused_mlp.reset_launches()
    fn()
    return {"mlp2": fused_mlp.MLP2_LAUNCHES, "mlp3": fused_mlp.MLP3_LAUNCHES,
            **fused_mlp.VARIANT_LAUNCHES}


def serving_rows(h: int, w: int, chunk: int, dn: int, stride: int, c2w,
                 w2c: torch.Tensor) -> torch.Tensor:
    """Pixel coordinates (rfn, n, 2) of one chunk's strided samples in the
    reference views, depth-major as the serving frame fetches them: the
    chunk's rays from a third of the way down the panorama, ``dn``
    samples, every ``stride``-th one."""
    dev = w2c.device
    conv = get_convention("m3d")
    i = torch.arange(chunk, dtype=torch.float32, device=dev)
    coords = torch.stack([i % w, i // w + h // 3], -1)[None]
    depth, _ = ro.sample_depth(1, chunk, dn, 0.5, 15.0, True, dev)
    pts, _ = ro.depth2points_spherical(
        coords, depth, torch.as_tensor(c2w, dtype=torch.float32, device=dev),
        conv.ray_directions(h, w, dev))
    flat = pts.transpose(1, 2)[:, ::stride].reshape(-1, 3)
    cam = torch.einsum("vij,pj->pvi", w2c[:, :, :3], flat) \
        + w2c[None, :, :, 3]
    xy, _ = conv.project_to_pixels(cam, h, w)
    return xy.transpose(0, 1).contiguous()


def frame_rows(h: int, w: int, chunk: int, dn: int, strides: tuple,
               clr: int, c2w, w2c: torch.Tensor) -> torch.Tensor:
    """The rows one chunk of the frame fetches from the merged map: the
    coarse pass's 64 samples at stride ``strides[0]`` (1/clr^2 of them: at
    low-res factor clr the coarse pass has 1/clr^2 of the rays), then the
    fine pass's ``dn`` at ``strides[1]``; (rfn, n, 2)."""
    rc = serving_rows(h, w, chunk, 64, strides[0], c2w, w2c)
    rc = rc[:, :max(rc.shape[1] // (clr * clr), 1)]
    return torch.cat([rc, serving_rows(h, w, chunk, dn, strides[1], c2w,
                                       w2c)], 1)


def gather_step(merged: torch.Tensor):
    """One bilinear fetch of every point's 2x2 window of ``merged``, as a
    step of ``time_chain`` (the next points depend on the rows)."""
    h, w = merged.shape[1:3]

    def step(pts):
        v = interpolate_feats_pointmajor(merged, pts, h, w)
        return pts + v[..., 0].float().mean() * 1e-9
    return step


def roofline(model, kw: dict, ref_info: dict, c2w, chunk: int, clr: int,
             dev: torch.device) -> dict:
    """The aggregation (prob embed -> pool -> attention -> heads) and the
    strided merged-map fetch of both passes, each iterated alone at
    ``chunk`` rays, scaled to the frame and priced by
    ``utils/roofline.py``."""
    h, w = model.height, model.width
    dn = kw.get("fine_depth_sample_num", 64)
    cdt = model.compute_dtype
    iters = 128 if dev.type == "cuda" else 2
    rng = np.random.default_rng(1)
    f0 = torch.as_tensor(rng.normal(size=(1, chunk, dn, RFN, 32)) * 0.3,
                         dtype=cdt, device=dev)
    prj = {"ray_feats": f0, "img_feats": f0, "rgb": f0[..., :3],
           "dir_diff": f0[..., :4], "hit_prob": f0[..., :1],
           "vis": f0[..., :1]}
    agg = DefaultAggregationNet()
    init_parameters_(agg, torch.Generator().manual_seed(0))
    agg.to(dev)

    def g_agg(p):
        density, _ = agg(p)
        upd = (1e-6 * density[..., None, None]).to(cdt)
        return {k: v + upd if v.shape[-1] == 1 else v for k, v in p.items()}

    with torch.inference_mode():
        agg_chunk_s = time_chain(g_agg, prj, iters, dev)
        row_ch = 3 + 64 + (10 if kw["decode_on_map"] else 0)
        merged = torch.as_tensor(rng.uniform(size=(RFN, h, w, row_ch)),
                                 dtype=cdt, device=dev)
        s_c = kw["gather_stride"]
        s_f = kw["gather_stride_fine"] or s_c
        w2c = torch.as_tensor(ref_info["w2c"], dtype=torch.float32,
                              device=dev)
        pts0 = frame_rows(h, w, chunk, dn, (s_c, s_f), clr, c2w, w2c)
        gather_chunk_s = time_chain(gather_step(merged), pts0, iters, dev)
    n_chunks = h * w / chunk
    # the coarse pass (geometry only) priced as the timed full pass, on
    # 1/f^2 of the rays
    agg_s = agg_chunk_s * n_chunks * (1 + 1 / (clr * clr))
    gather_s = gather_chunk_s * n_chunks
    fm = rl.frame_model(h, w, dn_fine=dn, stride=s_c, stride_fine=s_f,
                        v=RFN, lowres_coarse=clr, dtype=kw["compute_dtype"])
    out = {"agg_ms": agg_s * 1e3, "gather_ms": gather_s * 1e3,
           "agg_tflops": fm["agg_flops"] / 1e12,
           "gather_rows_M": fm["gather_rows"] / 1e6,
           # 4 rows (a 2x2 window) per point and view, at this run's chunk
           "gather_ns_per_row": gather_chunk_s * 1e9
           / (pts0.shape[0] * pts0.shape[1] * 4)}
    # fractions of the card's peaks mean nothing for a CPU run
    ach = rl.achieved(fm, agg_s, gather_s) if dev.type == "cuda" else {
        k: None for k in ("agg_mfu", "agg_hbm_frac", "gather_hbm_frac",
                          "gather_latency_model_frac")}
    out.update(ach)
    return out


def scene_prep_ms(model, ref_info: dict, h: int, w: int, dh: int, dw: int,
                  dev: torch.device) -> float:
    """Median ms of the per-scene work: the frozen UniFuse + MVS stack on
    the two reference views (each paired with the other) and
    ``prepare_ref`` on its depth."""
    # UniFuse needs >= 128x256 for its deepest cube -> ERP level
    stack = init_depth_stack(1, mono_hw=(max(h, 128), max(w, 256)),
                             depth_hw=(dh, dw), device=dev)
    imgs = torch.as_tensor(ref_info["imgs"], dtype=torch.float32, device=dev)
    w2c = torch.as_tensor(ref_info["w2c"], dtype=torch.float32, device=dev)

    @torch.inference_mode()
    def prep(i):
        x = imgs + 1e-6 * i
        d = stack(x, torch.flip(x, [0]), w2c, torch.flip(w2c, [0]))
        model.prepare_ref(x, d["mvs_depth"])

    return statistics.median(timed_runs(prep, dev))


def main(argv=None) -> dict:
    """Run the benchmark on ``argv``; prints its JSON line and returns it."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    on_cpu = dev.type == "cpu"
    H, W, DH, DW = SIZES[dev.type]
    kw = preset_kwargs(
        args.preset, fast_gather=args.fast_gather,
        gather_depth_major=args.depth_major,
        gather_stride=args.gather_stride,
        gather_stride_fine=args.gather_stride_fine,
        gather_nearest=args.gather_nearest,
        decode_on_map=args.decode_on_map,
        coarse_geometry_only=(args.coarse_geo_only and not args.diner)
        if (args.coarse_geo_only is not None or args.diner) else None,
        fine_depth_sample_num=args.fine_samples or None,
        depth_sample_num=args.coarse_samples or None,
        compute_dtype="float32" if on_cpu else None)
    if args.diner:
        kw["coarse_geometry_only"] = False
    model = NeuralRayGenRenderer(
        height=H, width=W, depth_hw=(DH, DW),
        light_coarse=args.light_coarse and not args.diner,
        coarse_proxy_samples=args.proxy_samples, ablate=args.ablate, **kw,
        device=dev, generator=torch.Generator().manual_seed(0)).eval()
    ref_info, c2w, qdr = bench_inputs(H, W, DH, DW)
    dr = ref_info["depth_range"]
    chunk = args.chunk or PRESET_CHUNK[args.preset]
    cchunk = (args.coarse_chunk if args.coarse_chunk is not None
              else PRESET_COARSE_CHUNK[args.preset])
    ref_data = full_render.prepare_ref_data(model, ref_info, device=dev)
    mode = "diner" if args.diner else "hierarchical"
    # the DINER and light-coarse paths have no standard coarse pass
    clr = (args.coarse_lowres if args.coarse_lowres is not None
           else PRESET_COARSE_LOWRES[args.preset])
    if args.diner or args.light_coarse:
        clr = 1
    if args.diner:
        ref_data["mvs_uncert"] = torch.full_like(ref_data["mvs_depth"], 0.04)

    def pose(i: int, offset: float = 0.0) -> np.ndarray:
        c = c2w.copy()
        c[2, 3] += 0.001 * i + offset
        return c

    def frame(c):
        rgb = full_render.render_image_device(
            model, ref_data, c, qdr, dr, chunk=chunk, mode=mode,
            coarse_lowres=clr, coarse_chunk=cchunk, device=dev)
        synchronize(dev)
        return rgb

    # the warm-up frame is the counted one
    launches = counted(lambda: frame(c2w))
    runs = timed_runs(lambda i: frame(pose(i)), dev, warmup=False)
    ms = statistics.median(runs)
    name = (f"torch_novel_pano_render_{H}x{W}" + ("_cpu" if on_cpu else "")
            + ("_diner" if args.diner else "")
            + (f"_{args.preset}" if args.preset != "serving" else "")
            + (f"_ablate_{args.ablate}" if args.ablate else "")
            + (f"_clr{clr}" if args.coarse_lowres is not None
               and clr != PRESET_COARSE_LOWRES[args.preset] else ""))
    result = {"metric": name, "value": ms, "unit": "ms/frame",
              "vs_baseline": None, "rays_per_sec": H * W / (ms / 1e3),
              "runs": runs, "spread": max(runs) - min(runs),
              "device": torch.cuda.get_device_name(dev) if not on_cpu
              else "cpu", "mlp2_launches": launches["mlp2"],
              "mlp2_lanes_launches": launches["mlp2_lanes"],
              "pool_fused_launches": launches["pool_fused"],
              "pool_plain_launches": launches["pool_plain"],
              "attn_fused_launches": launches["attn_fused"],
              "attn_plain_launches": launches["attn_plain"],
              "mlp3_launches": launches["mlp3"]}

    if (args.preset == "serving" and not args.ablate and not args.diner
            and not args.light_coarse and args.coarse_lowres is None
            and not args.fine_samples and not args.coarse_samples
            and args.chunk is None and args.coarse_chunk is None):
        # the default run also times the turbo point: the same model at
        # the turbo preset's chunk and coarse factor
        def turbo(i):
            full_render.render_image_device(
                model, ref_data, pose(i, 0.007), qdr, dr,
                chunk=PRESET_CHUNK["turbo"],
                coarse_lowres=PRESET_COARSE_LOWRES["turbo"], device=dev)
            synchronize(dev)
        result["turbo_ms_per_frame"] = statistics.median(timed_runs(turbo,
                                                                    dev))

    if args.video_batch:
        B = args.video_batch
        c2ws = np.stack([pose(0, 0.01 * b) for b in range(B)])

        def video(i):
            cs = c2ws.copy()
            cs[:, 2, 3] += 0.001 * (i + 3)
            full_render.render_video_device(
                model, ref_data, cs, qdr, dr, chunk=chunk, coarse_lowres=clr,
                coarse_chunk=cchunk, device=dev)
            synchronize(dev)
        vl = counted(lambda: video(0))
        result["video_ms_per_frame"] = statistics.median(
            timed_runs(video, dev, warmup=False)) / B
        result["video_batch"] = B
        result["video_mlp2_launches"] = vl["mlp2"]
        result["video_mlp2_lanes_launches"] = vl["mlp2_lanes"]
        result["video_pool_fused_launches"] = vl["pool_fused"]
        result["video_pool_plain_launches"] = vl["pool_plain"]
        result["video_attn_fused_launches"] = vl["attn_fused"]
        result["video_attn_plain_launches"] = vl["attn_plain"]

    if args.roofline and not args.diner and not args.ablate:
        result.update(roofline(model, kw, ref_info, c2w, chunk, clr, dev))

    if args.with_depth_stack:
        result["scene_prep_ms"] = scene_prep_ms(model, ref_info, H, W, DH,
                                                DW, dev)

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
