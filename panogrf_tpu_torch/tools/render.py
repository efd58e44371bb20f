"""Render novel panoramas of procedural scenes, with their metrics.

    python -m panogrf_tpu_torch.tools.render [--ckpt model.pth] [--num N] \\
        [--height H --width W] [--pose-type eval|inter] [--inter-num K] \\
        [--frame-batch B] [--preset serving] [--chunk C] \\
        [--depth-stack | --mono-ckpt F [--mvs-ckpt F] [--wo-stereo]] \\
        [--shards DIR] [--lpips-weights W] [--out DIR] [--mesh N] \\
        [--device cpu]

Port of the repo's ``tools/render.py``.  The scenes are procedural 3-view
samples, or with ``--shards`` the first ``--num`` samples of a shard
directory (``tools/prepare_data.py``, ``tools/import_lmdb.py``).  'eval'
renders the held-out query view of each scene and writes ``<i>-nr_fine.png``, ``<i>-gt.png`` and the
mean PSNR / SSIM / WS-PSNR (and LPIPS with ``--lpips-weights``, an
``.npz`` or a directory that ``train/lpips.load_lpips_weights`` reads)
with the seconds per frame in ``metric.txt``;
'inter' renders a path of ``--inter-num`` poses between the two reference
views, ``--frame-batch`` poses per pass (``render_video_device``), and
writes ``<i>-frame<k>.png`` and ``<i>-video.gif``.  Without imageio the
images are saved as ``.npy``.  Frames already on disk are skipped unless
``--no-skip``.

The reference views' depth comes from the scenes' true depth, or, with
``--mono-ckpt``/``--mvs-ckpt``/``--wo-stereo``/``--depth-stack``, from the
frozen depth stack (UniFuse, then the 360-degree MVS net): no true depth
is read then.  Checkpoints are reference-layout files or the JAX depth
trainers' orbax directories; without ``--mvs-ckpt`` the stack is UniFuse
alone, as in the JAX tool, and ``--depth-stack`` without checkpoints runs
it with random weights.  ``--ckpt`` is a renderer checkpoint in the
reference ``model.pth`` layout, which the port's trainer writes, or an
orbax directory of the JAX trainer (``data/model/<name>/latest``).

It runs on the CUDA device and raises without one unless ``--device cpu``
is given.  ``--mesh N`` renders each eval frame with its rays split over N
ranks, one process each (``parallel/launch.run_ranks``: NCCL on N cards,
gloo on the CPU with ``--device cpu``), the preset's low-res coarse pass
included (``parallel/sharded_render.py``); H*W must divide by N.  Pose
paths render on rank 0 alone, and rank 0 writes every file.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from panogrf_tpu_torch.data import imgs_info
from panogrf_tpu_torch.data.shards import ShardReader, sample_to_torch
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_three_view_sample)
from panogrf_tpu_torch.models.depth_stack import (load_depth_stack,
                                                  stack_depth_for_sample)
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.parallel.launch import run_ranks
from panogrf_tpu_torch.parallel.mesh import broadcast_object, make_mesh
from panogrf_tpu_torch.parallel.sharded_render import render_image_sharded
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer import poses as P
from panogrf_tpu_torch.renderer.presets import (PRESET_CHUNK,
                                                PRESET_COARSE_CHUNK,
                                                PRESET_COARSE_LOWRES,
                                                preset_kwargs)
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.train import lpips as L
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.train.trainer import load_checkpoint_params
from panogrf_tpu_torch.utils.device import resolve_device, synchronize


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="renderer model.pth, or an orbax directory of "
                         "the JAX trainer")
    ap.add_argument("--num", type=int, default=2)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--depth-height", type=int, default=128)
    ap.add_argument("--depth-width", type=int, default=256)
    ap.add_argument("--m3d-dist", type=float, default=0.5)
    ap.add_argument("--out", default="data/render_out")
    ap.add_argument("--pose-type", default="eval", choices=["eval", "inter"])
    ap.add_argument("--inter-num", type=int, default=12)
    ap.add_argument("--frame-batch", type=int, default=4,
                    help="path poses rendered together per pass; 1 = the "
                         "per-frame path")
    ap.add_argument("--no-skip", action="store_true",
                    help="re-render frames even if the file exists")
    ap.add_argument("--preset", default="serving",
                    choices=["exact", "serving", "turbo"])
    ap.add_argument("--exact", action="store_true",
                    help="alias for --preset exact")
    ap.add_argument("--gather-stride", type=int, default=None)
    ap.add_argument("--gather-stride-fine", type=int, default=None)
    ap.add_argument("--no-decode-on-map", dest="decode_on_map",
                    action="store_false", default=None)
    ap.add_argument("--coarse-lowres", type=int, default=None)
    ap.add_argument("--samples", type=int, default=0,
                    help="coarse sample count (0 = the preset's 64)")
    ap.add_argument("--fine-samples", type=int, default=0,
                    help="fine sample count (0 = the preset's 64)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="rays per chunk pass (0 = the preset's)")
    ap.add_argument("--mono-ckpt", default=None,
                    help="UniFuse checkpoint (reference-layout file, or "
                         "an orbax directory of the JAX trainer)")
    ap.add_argument("--mvs-ckpt", default=None,
                    help="MVS checkpoint (reference-layout file, or an "
                         "orbax directory of the JAX trainer)")
    ap.add_argument("--wo-stereo", action="store_true",
                    help="mono-only depth: skip the MVS net")
    ap.add_argument("--depth-stack", action="store_true",
                    help="run the depth stack even without checkpoints "
                         "(UniFuse alone unless --mvs-ckpt; random weights "
                         "without --mono-ckpt)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--shards", default=None,
                    help="render the first --num samples of this shard "
                         "directory instead of procedural scenes")
    ap.add_argument("--lpips-weights", default=None,
                    help="LPIPS weights (.npz, or a directory with "
                         "vgg16.pth and lpips_vgg.pth): score each eval "
                         "frame")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="split each eval frame's rays over N ranks (one "
                         "card each; --device cpu: N CPU processes)")
    args = ap.parse_args(argv)
    if args.exact:
        args.preset = "exact"
    return args


def save_image(path: Path, img) -> None:
    arr = np.asarray(np.clip(np.asarray(img) * 255.0, 0, 255), np.uint8)
    try:
        import imageio.v2 as imageio
        imageio.imwrite(path, arr)
    except Exception:
        np.save(path.with_suffix(".npy"), arr)


def main(argv=None) -> dict:
    """Run the tool on ``argv``; returns a summary: per-frame metrics of
    'eval', their mean, per-scene path timings of 'inter', the depth
    stack's nets and its seconds per scene (rank 0's with ``--mesh``)."""
    args = parse_args(argv)
    if args.mesh:
        n = args.height * args.width
        if n % args.mesh:
            raise ValueError(f"{args.height}x{args.width} = {n} rays do not "
                             f"split over {args.mesh} ranks")
        return run_ranks(run_rank, args.mesh, args.device, (args,))
    return run(args)


def run_rank(args: argparse.Namespace) -> dict:
    """One rank of ``--mesh``: ``run`` on the mesh of ``args.mesh``
    ranks."""
    return run(args, make_mesh(args.mesh, device=args.device))


def run(args: argparse.Namespace, mesh=None) -> dict:
    """The tool on parsed ``args``; with a ``mesh`` this rank's part."""
    chief = mesh is None or mesh.rank == 0
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    H, W = args.height, args.width
    DH, DW = args.depth_height, args.depth_width
    kw = preset_kwargs(args.preset, gather_stride=args.gather_stride,
                       gather_stride_fine=args.gather_stride_fine,
                       decode_on_map=args.decode_on_map,
                       depth_sample_num=args.samples or None,
                       fine_depth_sample_num=args.fine_samples or None,
                       compute_dtype="float32" if dev.type == "cpu"
                       else None)
    model = NeuralRayGenRenderer(height=H, width=W, depth_hw=(DH, DW), **kw,
                                 device=dev,
                                 generator=torch.Generator().manual_seed(0))
    if args.ckpt:
        model.load_state_dict(load_checkpoint_params(args.ckpt))
        print(f"restored {args.ckpt}")
    model.eval()
    clr = (args.coarse_lowres if args.coarse_lowres is not None
           else PRESET_COARSE_LOWRES[args.preset])
    if H % clr or W % clr:
        print(f"coarse-lowres {clr} does not divide {H}x{W}; disabling")
        clr = 1
    chunk = args.chunk or PRESET_CHUNK[args.preset]
    # with a mesh each rank's share of the rays is split into chunks
    while (H * W // (mesh.size if mesh is not None else 1)) % chunk:
        chunk //= 2
    coarse_chunk = PRESET_COARSE_CHUNK[args.preset]

    out_dir = Path(args.out)
    if chief:
        out_dir.mkdir(parents=True, exist_ok=True)

    summary = {"frames": [], "videos": [], "stack_seconds": []}
    stack = None
    if args.mono_ckpt or args.mvs_ckpt or args.wo_stereo or args.depth_stack:
        stack = load_depth_stack(
            args.mono_ckpt, args.mvs_ckpt,
            # UniFuse's cube fusion needs W >= 128 (1/32-scale ERP)
            mono_hw=(max(H, 64), max(W, 128)),
            # the MVS UNet needs >= 32 rows; its depth is resized to DH, DW
            depth_hw=(max(DH, 32), max(DW, 64)), wo_stereo=args.wo_stereo,
            device=dev)
        mvs = args.mvs_ckpt or ("-" if stack.mvs_model is None
                                else "random")
        print(f"depth stack: mono={args.mono_ckpt or 'random'} mvs={mvs}")
        summary["depth_stack"] = {"mono": args.mono_ckpt or "random",
                                  "mvs": mvs}

    lpips_score = None
    if args.lpips_weights and chief:
        lpips_score = L.lpips_fn(L.load_lpips_weights(args.lpips_weights,
                                                      dev))

    coords = imgs_info.sample_train_coords(np.random.default_rng(0), H, W, 8,
                                           device=dev)
    reader = ShardReader(args.shards) if args.shards else None
    num = min(args.num, len(reader)) if reader is not None else args.num
    for qi in range(num):
        skip = not args.no_skip and args.pose_type == "eval" and \
            (out_dir / f"{qi}-nr_fine.png").exists()
        if mesh is not None:
            skip = broadcast_object(skip, mesh)
        if skip:
            print(f"[{qi}] exists, skipping")
            continue
        if args.pose_type == "inter" and not chief:
            continue
        if reader is not None:
            s = sample_to_torch(reader[qi], dev)
        else:
            s = make_three_view_sample(
                SphereScene.random(9000 + qi, device=dev), H, W,
                args.m3d_dist, seed=100 + qi)
        data = imgs_info.build_render_sample(s, coords)
        ref_info = data["ref_imgs_info"]
        que_info = data["que_imgs_info"]
        if stack is not None:
            synchronize(dev)
            t0 = time.perf_counter()
            pred = stack_depth_for_sample(stack, s, imgs_info.REF_IDS,
                                          imgs_info.SRC_IDS)
            synchronize(dev)
            summary["stack_seconds"].append(time.perf_counter() - t0)
            ref_info["mvs_depth"] = resize_linear(pred["mvs_depth"],
                                                  (DH, DW), axes=(1, 2))
        else:
            ref_info["mvs_depth"] = resize_linear(
                s["depth_panos"][list(imgs_info.REF_IDS)], (DH, DW),
                axes=(1, 2))
        qdr = que_info["depth_range"]

        if args.pose_type == "inter":
            c2w_all = imgs_info.c2w_from_w2c(
                imgs_info.pose_w2c(s["rots"], s["trans"])).cpu().numpy()
            path = P.prepare_render_info(c2w_all, "inter",
                                         inter_num=args.inter_num)
            ref_data = full_render.prepare_ref_data(model, ref_info,
                                                    device=dev)
            fb = max(1, args.frame_batch)
            frames = []
            synchronize(dev)
            t0 = time.perf_counter()
            for g0 in range(0, len(path), fb):
                grp = path[g0:g0 + fb]
                ng = grp.shape[0]
                if ng < fb:       # pad to the group size; trimmed below
                    grp = np.concatenate([grp, np.repeat(grp[-1:], fb - ng,
                                                         axis=0)])
                if fb > 1:
                    rgbs = full_render.render_video_device(
                        model, ref_data, grp, qdr, ref_info["depth_range"],
                        chunk=chunk, coarse_lowres=clr,
                        coarse_chunk=coarse_chunk, device=dev)
                else:
                    rgbs = full_render.render_image_device(
                        model, ref_data, grp[0], qdr,
                        ref_info["depth_range"], chunk=chunk,
                        coarse_lowres=clr, coarse_chunk=coarse_chunk,
                        device=dev)[None]
                frames += list(rgbs[:ng].cpu().numpy())
            synchronize(dev)
            seconds = time.perf_counter() - t0
            summary["videos"].append({"scene": qi, "frames": len(frames),
                                      "frame_batch": fb, "seconds": seconds,
                                      "sec_per_frame": seconds / len(frames)})
            frames8 = []
            for fi, rgb in enumerate(frames):
                save_image(out_dir / f"{qi}-frame{fi:03d}.png", rgb)
                frames8.append(np.asarray(np.clip(rgb * 255.0, 0, 255),
                                          np.uint8))
            try:
                import imageio.v2 as imageio
                imageio.mimsave(out_dir / f"{qi}-video.gif", frames8,
                                duration=0.125, loop=0)
                print(f"[{qi}] wrote {len(frames)} path frames + "
                      f"{qi}-video.gif ({seconds / len(frames):.3f} s/frame)")
            except Exception as e:  # no imageio, or no gif codec
                print(f"[{qi}] wrote {len(frames)} path frames "
                      f"({seconds / len(frames):.3f} s/frame; gif assembly "
                      f"failed: {e})")
            continue

        synchronize(dev)
        t0 = time.perf_counter()
        if mesh is not None:
            ref_data = full_render.prepare_ref_data(model, ref_info,
                                                    device=dev)
            rgb = render_image_sharded(
                model, ref_data, que_info["c2w"], qdr,
                ref_info["depth_range"], mesh, coarse_lowres=clr,
                chunk=chunk, coarse_chunk=coarse_chunk)
        elif clr > 1:
            ref_data = full_render.prepare_ref_data(model, ref_info,
                                                    device=dev)
            rgb = full_render.render_image_device(
                model, ref_data, que_info["c2w"], qdr,
                ref_info["depth_range"], chunk=chunk, coarse_lowres=clr,
                coarse_chunk=coarse_chunk, device=dev)
        else:
            rgb = full_render.render_image(
                model, ref_info, que_info["c2w"], qdr,
                chunk=min(8192, H * W), device=dev)["rgb"]
        synchronize(dev)
        dt = time.perf_counter() - t0
        if not chief:
            continue
        gt = s["rgb_panos"][imgs_info.QUE_ID]
        m = {k: float(v) for k, v in M.render_metrics(rgb, gt).items()}
        if lpips_score is not None:
            m["lpips"] = float(lpips_score(gt[None], rgb[None])[0])
        m["sec_per_frame"] = dt
        summary["frames"].append(m)
        save_image(out_dir / f"{qi}-nr_fine.png", rgb.cpu().numpy())
        save_image(out_dir / f"{qi}-gt.png", gt.cpu().numpy())
        print(f"[{qi}] " + " ".join(f"{k}={v:.3f}" for k, v in m.items()))

    if summary["frames"] and chief:
        summary["mean"] = {k: float(np.mean([m[k] for m in summary["frames"]]))
                           for k in summary["frames"][0]}
        (out_dir / "metric.txt").write_text(json.dumps(summary["mean"],
                                                       indent=2))
        print("mean:", json.dumps(summary["mean"]))
    return summary


if __name__ == "__main__":
    main()
