"""Train the generalizable renderer on procedural scenes or array shards.

    python -m panogrf_tpu_torch.tools.train_renderer [--cfg <yaml>] \\
        [--steps N] [--pool P | --shards DIR] [--mv V] \\
        [--count-jitter 64,64,48,32] \\
        [--depth-source gt|stack] [--mono-ckpt F] [--mvs-ckpt F] \\
        [--wo-stereo] [--mesh N] [--device cpu]

Port of the repo's ``tools/train_renderer.py``.  It reads the repo's YAML
configs (the default config without ``--cfg``), pre-renders a pool of
``--pool`` synthetic scenes on the device, or with ``--shards`` reads a
random sample of a shard directory (``tools/prepare_data.py``,
``tools/import_lmdb.py``) each step, draws 512 training rays per step and
trains with Adam on the config's lr schedule; the checkpoint
lands in ``<save_dir>/<name>/latest/model.pth``.  Every ``val_interval``
steps it renders the query view of 2 fixed validation scenes (seeds
10000 + i), logs their mean PSNR / SSIM / WS-PSNR and keeps the best
checkpoint by ``psnr_nr`` in ``<save_dir>/<name>/best``; each validation
writes the scenes' ``gt | pred`` images and turbo depth maps under
``<save_dir>/<name>/vis``.

Scenes follow the 3-view protocol (query view 1, references [0, 2]), or,
with ``--mv V`` or a config with ``test_views``, the multi-view one: V
views along one axis, the references ``range(reference_idx)`` (``range(V
- 1)`` for a bare ``--mv``) and a query drawn each step from
``test_views`` (view V - 1 for a bare ``--mv``).  The reference views'
depth is the scenes' true depth, or with ``--depth-source stack``
(implied by ``--mono-ckpt``/``--mvs-ckpt``/``--wo-stereo``) the frozen
depth stack's prediction, each view paired with the next reference,
kept for the last ``DEPTH_CACHE_SIZE`` scenes met.  A config with ``use_self_hit_prob`` trains the
consistency loss: the query view's depth comes from the same source,
paired with the first reference.  It runs on the CUDA device and raises
without one unless ``--device cpu`` is given.

``--mesh N`` splits each step's 512 rays over N ranks, one process each
(``parallel/launch.run_ranks``: NCCL on N cards, gloo on the CPU with
``--device cpu``): every rank builds the same pool (or reads the same
shard samples) and draws the same rays and samples, renders its share of
the rays, and the gradients are summed, so a step equals the
single-device step up to rounding; rank 0 prints, validates and writes
the checkpoints.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from panogrf_tpu_torch.config import load_config
from panogrf_tpu_torch.data import imgs_info
from panogrf_tpu_torch.data.shards import ShardReader, sample_to_torch
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_multi_view_sample,
                                              make_three_view_sample)
from panogrf_tpu_torch.models.depth_stack import (load_depth_stack,
                                                  stack_depth_for_sample)
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.parallel.launch import run_ranks
from panogrf_tpu_torch.parallel.mesh import make_mesh
from panogrf_tpu_torch.parallel.programs import param_grads
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.train.trainer import Trainer, TrainerConfig
from panogrf_tpu_torch.utils import visualize as V
from panogrf_tpu_torch.utils.device import resolve_device

TRAIN_RAYS = 512
# stack depth maps kept, one a scene and view set: at a 256x512 depth grid
# and two references, 1 MiB each
DEPTH_CACHE_SIZE = 256


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", default=None,
                    help="config yaml (default: the default config)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--pool", type=int, default=16,
                    help="procedural scene pool size")
    ap.add_argument("--count-jitter", default="",
                    help="comma list of fine sample counts (duplicates "
                         "weight the per-step draw): one checkpoint trained "
                         "with the fine count drawn per step")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--log-interval", type=int, default=100,
                    help="print the losses every N steps (and after step 1)")
    ap.add_argument("--depth-source", default=None, choices=["gt", "stack"],
                    help="reference depth: the scenes' true depth ('gt', "
                         "the default) or the frozen depth stack's "
                         "prediction ('stack', implied by the next three)")
    ap.add_argument("--mono-ckpt", default=None,
                    help="UniFuse checkpoint (reference-layout file)")
    ap.add_argument("--mvs-ckpt", default=None,
                    help="MVS checkpoint (reference-layout file)")
    ap.add_argument("--wo-stereo", action="store_true",
                    help="mono-only stack depth: skip the MVS net")
    ap.add_argument("--shards", default=None,
                    help="train on this shard directory's samples instead "
                         "of the procedural pool")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help=f"split the {TRAIN_RAYS} rays of each step over N "
                         "ranks (one card each; --device cpu: N CPU "
                         "processes)")
    ap.add_argument("--mv", type=int, default=0, metavar="V",
                    help="multi-view training with V > 2 views: references "
                         "range(V - 1), query view V - 1")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, log_fn=None, mesh=None) -> tuple:
    """(trainer, batch iterator, number of steps) for ``args``; ``log_fn``
    (step, metrics) is called beside the printed log.  With a ``mesh``
    (``parallel.mesh.Mesh``) the trainer splits the rays over it, on this
    rank's device."""
    cfg = load_config(args.cfg)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    num_steps = args.steps or cfg.train.total_step
    R = cfg.renderer
    H, W = R.height, R.width
    DH, DW = cfg.mvs.depth_height, cfg.mvs.depth_width
    model_kw = dict(
        height=H, width=W, depth_hw=(DH, DW), min_depth=R.min_depth,
        max_depth=R.max_depth, mvs_min_depth=cfg.mvs.mvs_min_depth,
        mvs_max_depth=cfg.mvs.mvs_max_depth,
        depth_sample_num=R.depth_sample_num,
        fine_depth_sample_num=R.fine_depth_sample_num,
        use_hierarchical_sampling=R.use_hierarchical_sampling,
        use_disp=R.use_disp, use_self_hit_prob=R.use_self_hit_prob,
        # gather rows in depth-major order, as the JAX recipe does
        gather_depth_major=True)
    model = NeuralRayGenRenderer(
        **model_kw, device=dev,
        generator=torch.Generator().manual_seed(cfg.train.seed))
    print(f"renderer params: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")

    # the multi-view protocol: V views, references range(reference_idx)
    # (range(V - 1) for a bare --mv), the query drawn from test_views
    mv = args.mv or (cfg.data.seq_len if cfg.data.test_views else 0)
    if mv:
        n_ref = cfg.data.reference_idx if cfg.data.test_views else mv - 1
        ref_ids = list(range(n_ref))
        que_ids = list(cfg.data.test_views) or [mv - 1]
    else:
        ref_ids, que_ids = list(imgs_info.REF_IDS), [imgs_info.QUE_ID]

    def make_sample(scene: SphereScene, seed: int) -> dict:
        if mv:
            return make_multi_view_sample(scene, H, W, mv, cfg.data.m3d_dist,
                                          seed=seed)
        return make_three_view_sample(scene, H, W, cfg.data.m3d_dist,
                                      seed=seed)

    rng = np.random.default_rng(cfg.train.seed)
    reader = ShardReader(args.shards) if args.shards else None
    # without shards, a pool of procedural scenes rendered once
    pool = [] if reader is not None else [
        make_sample(SphereScene.random(int(rng.integers(1 << 30)),
                                       device=dev), i)
        for i in range(args.pool)]

    stack = None
    if args.depth_source == "stack" or (args.depth_source is None and (
            args.mono_ckpt or args.mvs_ckpt or args.wo_stereo)):
        stack = load_depth_stack(
            args.mono_ckpt, args.mvs_ckpt,
            # UniFuse's cube fusion needs W >= 128 (1/32-scale ERP)
            mono_hw=(max(H, 64), max(W, 128)),
            # the MVS UNet needs >= 32 rows; its depth is resized to DH, DW
            depth_hw=(max(DH, 32), max(DW, 64)), wo_stereo=args.wo_stereo,
            device=dev)
        print(f"depth source: frozen stack (mono="
              f"{args.mono_ckpt or 'random'}, mvs={args.mvs_ckpt or '-'})")

    # a scene's depth of given views on the init net's grid.  The stack's
    # prediction depends only on the scene's images and poses, so it is
    # kept for the DEPTH_CACHE_SIZE scenes met last (a shard directory
    # holds far more than the card should keep); the stored depth is only
    # resized, and is not kept
    depth_cache: dict = {}

    def view_depth(s: dict, key, ids, srcs) -> torch.Tensor:
        if stack is None:
            return resize_linear(s["depth_panos"][list(ids)], (DH, DW),
                                 axes=(1, 2))
        if key not in depth_cache:
            if len(depth_cache) >= DEPTH_CACHE_SIZE:
                del depth_cache[next(iter(depth_cache))]
            d = stack_depth_for_sample(stack, s, ids, srcs)["mvs_depth"]
            depth_cache[key] = resize_linear(d, (DH, DW), axes=(1, 2))
        return depth_cache[key]

    def ref_depth(s: dict, key) -> torch.Tensor:
        # each reference's source is the next reference, cyclically: the
        # 3-view protocol's SRC_IDS for references (0, 2)
        return view_depth(s, key, ref_ids, None)

    def batches():
        while True:
            if reader is not None:
                si = int(rng.integers(len(reader)))
                s, key = sample_to_torch(reader[si], dev), ("shard", si)
            else:
                si = int(rng.integers(len(pool)))
                s, key = pool[si], ("pool", si)
            coords = imgs_info.sample_train_coords(rng, H, W, TRAIN_RAYS,
                                                   device=dev)
            if mv:
                que = que_ids[int(rng.integers(len(que_ids)))]
                data = imgs_info.build_render_sample_mv(
                    s, coords, ref_ids, que, (R.min_depth, R.max_depth))
            else:
                que = que_ids[0]
                data = imgs_info.build_render_sample(
                    s, coords, (R.min_depth, R.max_depth),
                    src_for_mvs=False)
            data["ref_imgs_info"]["mvs_depth"] = ref_depth(s, key)
            if R.use_self_hit_prob:
                # the consistency loss encodes the query view too
                data["que_imgs_info"]["mvs_depth"] = view_depth(
                    s, key + ("que", que), [que], [ref_ids[0]])
            yield data

    # fixed validation scenes: the query view rendered in full, its
    # metrics averaged; the trainer keeps the best checkpoint by psnr_nr
    val_scenes = [make_sample(SphereScene.random(10_000 + vi, device=dev),
                              10_000 + vi) for vi in range(2)]

    vis_dir = Path(cfg.train.save_dir) / cfg.train.name / "vis"

    def val_fn(model, step) -> dict:
        vals = []
        for vi, s in enumerate(val_scenes):
            ref_info = imgs_info.build_imgs_info(
                s, ref_ids, (R.min_depth, R.max_depth))
            ref_info["mvs_depth"] = ref_depth(s, ("val", vi))
            que_w2c = imgs_info.pose_w2c(s["rots"], s["trans"])[que_ids[0]]
            c2w = imgs_info.c2w_from_w2c(que_w2c[None])[0]
            out = full_render.render_image(
                model, ref_info, c2w, [[R.min_depth, R.max_depth]],
                chunk=min(8192, H * W), device=dev)
            gt = s["rgb_panos"][que_ids[0]]
            m = M.render_metrics(out["rgb"], gt)
            V.dump_render_val(vis_dir, step, vi, gt.cpu().numpy(),
                              out["rgb"].cpu().numpy(),
                              pred_depth=out["depth"].cpu().numpy())
            vals.append({k: float(v) for k, v in m.items()})
        return {k: float(np.mean([v[k] for v in vals])) for k in vals[0]}

    tc = TrainerConfig(
        name=cfg.train.name, total_step=num_steps,
        val_interval=cfg.train.val_interval,
        save_interval=cfg.train.save_interval, lr_type=cfg.train.lr_type,
        lr_cfg={"lr_init": cfg.train.lr_init,
                "decay_step": cfg.train.decay_step,
                "decay_rate": cfg.train.decay_rate},
        losses=tuple(n for n in cfg.train.loss
                     if n in ("render", "depth", "consistency")),
        loss_kwargs={"render": {
            "use_ray_mask": R.use_ray_mask,
            "use_polar_weighted_loss": R.use_polar_weighted_loss}},
        seed=cfg.train.seed, save_dir=cfg.train.save_dir,
        log_interval=args.log_interval)

    variant_probs = None
    if args.count_jitter:
        counts = [int(c) for c in args.count_jitter.split(",")]
        variant_probs = {f"f{c}": counts.count(c) for c in set(counts)}
        forward_fn = {f"f{c}": (lambda b, g, _c=c: model(b, g, _c))
                      for c in set(counts)}
        print(f"count-jitter training: fine counts {sorted(set(counts))} "
              f"weights {variant_probs}")
    else:
        def forward_fn(b, g):
            return model(b, g)

    t0 = time.time()

    def log(step, m):
        print(f"step {step} ({time.time() - t0:.0f}s): "
              + " ".join(f"{k}={v:.4f}" for k, v in m.items()), flush=True)
        if log_fn is not None:
            log_fn(step, m)

    trainer = Trainer(model, forward_fn, tc, val_fn=val_fn, log_fn=log,
                      variant_probs=variant_probs, mesh=mesh)
    return trainer, batches(), num_steps


def run(args: argparse.Namespace, log_fn=None, mesh=None) -> Trainer:
    """Build, train and save as the CLI does."""
    return train(*build(args, log_fn, mesh))


def train(trainer: Trainer, stream, num_steps: int) -> Trainer:
    """Train and save as the CLI does."""
    trainer.fit(stream, num_steps, key_metric="psnr_nr")
    print(f"saved {trainer.save('latest')}")
    return trainer


def run_rank(args: argparse.Namespace, log_fn=None) -> dict:
    """``run`` on the mesh of ``args.mesh`` ranks (one rank of ``--mesh``),
    or without a mesh when ``args.mesh`` is 0; returns the last step, the
    checkpoint, the logged losses and the first step's (clipped) gradients
    of the whole batch as numpy."""
    record = {"losses": [], "grads": None}

    def log(step, metrics):
        if "loss" in metrics:
            record["losses"].append(metrics["loss"])
            if record["grads"] is None:
                # ``trainer`` is bound below, before its first step
                record["grads"] = param_grads(trainer.model)
        if log_fn is not None:
            log_fn(step, metrics)
    mesh = make_mesh(args.mesh, device=args.device) if args.mesh else None
    trainer, stream, num_steps = build(args, log, mesh)
    train(trainer, stream, num_steps)
    return {"step": trainer.step, **record,
            "checkpoint": str(trainer.ckpt_path())}


def main(argv=None, log_fn=None):
    """Run the CLI on ``argv``; returns the trained ``Trainer``, or with
    ``--mesh`` rank 0's ``run_rank`` result (``log_fn`` must then be
    picklable, unless N is 1)."""
    args = parse_args(argv)
    if args.mesh:
        if TRAIN_RAYS % args.mesh:
            raise SystemExit(f"--mesh {args.mesh} must divide the "
                             f"{TRAIN_RAYS} rays of a step")
        return run_ranks(run_rank, args.mesh, args.device, (args, log_fn))
    return run(args, log_fn)


if __name__ == "__main__":
    main()
