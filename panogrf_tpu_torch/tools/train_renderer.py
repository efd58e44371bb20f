"""Train the generalizable renderer on procedural scenes.

    python -m panogrf_tpu_torch.tools.train_renderer --cfg <yaml> \\
        [--steps N] [--pool P] [--count-jitter 64,64,48,32] \\
        [--depth-source gt|stack] [--mono-ckpt F] [--mvs-ckpt F] \\
        [--wo-stereo] [--device cpu]

Port of the repo's ``tools/train_renderer.py`` (2-view protocol).  It reads
the repo's YAML configs, pre-renders a pool of ``--pool`` synthetic scenes
on the device, draws 512 training rays per step and trains with Adam on
the config's lr schedule; the checkpoint lands in
``<save_dir>/<name>/latest/model.pth``.  Every ``val_interval`` steps it
renders the query view of 2 fixed validation scenes (seeds 10000 + i),
logs their mean PSNR / SSIM / WS-PSNR and keeps the best checkpoint by
``psnr_nr`` in ``<save_dir>/<name>/best``; each validation writes the
scenes' ``gt | pred`` images and turbo depth maps under
``<save_dir>/<name>/vis``.  The reference views' depth is
the scenes' true depth, or with ``--depth-source stack`` (implied by
``--mono-ckpt``/``--mvs-ckpt``/``--wo-stereo``) the frozen depth stack's
prediction, computed once per scene.  It runs on the CUDA device and
raises without one unless ``--device cpu`` is given.

Not ported yet, and refused with an error: ``--shards``, ``--mesh``,
``--mv`` (and configs with ``test_views``) and the consistency loss's
``use_self_hit_prob``.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from panogrf_tpu_torch.config import load_config
from panogrf_tpu_torch.data import imgs_info
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_three_view_sample)
from panogrf_tpu_torch.models.depth_stack import (load_depth_stack,
                                                  stack_depth_for_sample)
from panogrf_tpu_torch.nn.blocks import resize_linear
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.train.trainer import Trainer, TrainerConfig
from panogrf_tpu_torch.utils import visualize as V
from panogrf_tpu_torch.utils.device import resolve_device

TRAIN_RAYS = 512


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", required=True)
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
    ap.add_argument("--shards", default=None, help="not ported yet")
    ap.add_argument("--mesh", type=int, default=0, help="not ported yet")
    ap.add_argument("--mv", type=int, default=0, help="not ported yet")
    return ap.parse_args(argv)


def _refuse_unported(args, cfg) -> None:
    unported = {
        "--shards (offline shard reader)": args.shards,
        "--mesh (multi-GPU training)": args.mesh,
        "--mv / test_views (multi-view protocol)":
            args.mv or cfg.data.test_views,
        "use_self_hit_prob (consistency loss)":
            cfg.renderer.use_self_hit_prob,
    }
    for what, asked in unported.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported to "
                                      "panogrf_tpu_torch yet")


def build(args: argparse.Namespace, log_fn=None) -> tuple:
    """(trainer, batch iterator, number of steps) for ``args``; ``log_fn``
    (step, metrics) is called beside the printed log."""
    cfg = load_config(args.cfg)
    _refuse_unported(args, cfg)
    dev = resolve_device(args.device)
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
        use_disp=R.use_disp,
        # gather rows in depth-major order, as the JAX recipe does
        gather_depth_major=True)
    model = NeuralRayGenRenderer(
        **model_kw, device=dev,
        generator=torch.Generator().manual_seed(cfg.train.seed))
    print(f"renderer params: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")

    rng = np.random.default_rng(cfg.train.seed)
    pool = [make_three_view_sample(
        SphereScene.random(int(rng.integers(1 << 30)), device=dev), H, W,
        cfg.data.m3d_dist, seed=i) for i in range(args.pool)]

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

    # each scene's reference depth on the init net's grid, computed once:
    # the stack's prediction depends only on the scene's images and poses
    depth_cache: dict = {}

    def ref_depth(s: dict, key) -> torch.Tensor:
        if key not in depth_cache:
            if stack is not None:
                d = stack_depth_for_sample(stack, s, imgs_info.REF_IDS,
                                           imgs_info.SRC_IDS)["mvs_depth"]
            else:
                d = s["depth_panos"][list(imgs_info.REF_IDS)]
            depth_cache[key] = resize_linear(d, (DH, DW), axes=(1, 2))
        return depth_cache[key]

    def batches():
        while True:
            si = int(rng.integers(len(pool)))
            coords = imgs_info.sample_train_coords(rng, H, W, TRAIN_RAYS,
                                                   device=dev)
            data = imgs_info.build_render_sample(
                pool[si], coords, (R.min_depth, R.max_depth),
                src_for_mvs=False)
            data["ref_imgs_info"]["mvs_depth"] = ref_depth(pool[si],
                                                           ("pool", si))
            yield data

    # fixed validation scenes: the query view rendered in full, its
    # metrics averaged; the trainer keeps the best checkpoint by psnr_nr
    val_scenes = [make_three_view_sample(
        SphereScene.random(10_000 + vi, device=dev), H, W,
        cfg.data.m3d_dist, seed=10_000 + vi) for vi in range(2)]

    vis_dir = Path(cfg.train.save_dir) / cfg.train.name / "vis"

    def val_fn(model, step) -> dict:
        vals = []
        for vi, s in enumerate(val_scenes):
            ref_info = imgs_info.build_imgs_info(
                s, imgs_info.REF_IDS, (R.min_depth, R.max_depth))
            ref_info["mvs_depth"] = ref_depth(s, ("val", vi))
            que_w2c = imgs_info.pose_w2c(s["rots"], s["trans"])[
                imgs_info.QUE_ID]
            c2w = imgs_info.c2w_from_w2c(que_w2c[None])[0]
            out = full_render.render_image(
                model, ref_info, c2w, [[R.min_depth, R.max_depth]],
                chunk=min(8192, H * W), device=dev)
            gt = s["rgb_panos"][imgs_info.QUE_ID]
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
                      variant_probs=variant_probs)
    return trainer, batches(), num_steps


def main(argv=None, log_fn=None) -> Trainer:
    """Run the CLI on ``argv``; returns the trained ``Trainer``."""
    args = parse_args(argv)
    trainer, stream, num_steps = build(args, log_fn)
    trainer.fit(stream, num_steps, key_metric="psnr_nr")
    print(f"saved {trainer.save('latest')}")
    return trainer


if __name__ == "__main__":
    main()
