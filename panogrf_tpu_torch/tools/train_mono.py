"""Finetune a 360-degree mono-depth net (UniFuse by default).

    python -m panogrf_tpu_torch.tools.train_mono --steps 200 \\
        --height 128 --width 256 [--loss l1_sphere|berhu|gaussian_nll] \\
        [--uncertainty] [--mono-net UniFuse|Equi|ERP+TP|Cube] \\
        [--nrows 4 --patch-size 64] [--num-layers 2|18|34] [--device cpu]

Port of the repo's ``tools/train_mono.py``: each step draws ``--batch``
procedural scenes from ``np.random.default_rng(2022)`` (per sample a
``SphereScene.random`` seed, then the seed of the 3-view sample at
spacing 0.5), renders them on the device, trains on the middle view's
ImageNet-normalised panorama (and its cubemap at H/2 for UniFuse and
Cube; ERP+TP cuts its tangent patches itself, ``--nrows`` rows of
``--patch-size`` pixels) against its depth clipped to ``--max-depth``,
on a ResNet (``--num-layers`` 18, 34) or MobileNetV2 (2) encoder, with
Adam at a
constant lr behind an element-wise gradient clip of 1
(``train/depth_trainer.py``).  Checkpoints land in
``data/depth_model/<name>/checkpoint_<step>.pth``; ``--vis-interval``
writes turbo sheets under ``data/depth_model/<name>/vis``.  The run
resumes from the newest checkpoint of ``<name>``, then prints the ERP
depth metrics of 2 more batches.  It runs on the CUDA device and raises
without one unless ``--device cpu`` is given.

Not ported yet, and refused with an error: ``--shards`` and ``--mesh``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from panogrf_tpu_torch.core import cubemap
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_three_view_sample)
from panogrf_tpu_torch.models.unifuse import normalize_imagenet, select_mono
from panogrf_tpu_torch.nn.blocks import init_parameters_
from panogrf_tpu_torch.train.depth_trainer import (DepthTrainConfig,
                                                   DepthTrainer)
from panogrf_tpu_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--shards", default=None, help="not ported yet")
    ap.add_argument("--loss", default="l1_sphere")
    ap.add_argument("--uncertainty", action="store_true",
                    help="(mu, sigma) head trained with the Gaussian NLL")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--name", default="mono_run")
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--mono-net", default="UniFuse",
                    choices=["UniFuse", "Equi", "ERP+TP", "Cube"],
                    help="Equi = ERP branch only, ERP+TP = ERP and "
                         "tangent-patch branches, Cube = cube branch only")
    ap.add_argument("--nrows", type=int, default=4,
                    help="ERP+TP tangent-patch rows (3/4/5/6)")
    ap.add_argument("--patch-size", type=int, default=64,
                    help="ERP+TP tangent-patch size in pixels")
    ap.add_argument("--num-layers", type=int, default=18,
                    help="encoder: 2 = MobileNetV2, 18/34 = ResNet")
    ap.add_argument("--mesh", type=int, default=0, help="not ported yet")
    ap.add_argument("--vis-interval", type=int, default=100,
                    help="write rgb|gt|pred|error turbo sheets every N "
                         "steps (0 = off)")
    ap.add_argument("--log-interval", type=int, default=10,
                    help="print the loss every N steps (and after step 1)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def _refuse_unported(args) -> None:
    for what, asked in {"--shards (offline shard reader)": args.shards,
                        "--mesh (multi-GPU training)": args.mesh}.items():
        if asked:
            raise NotImplementedError(f"{what} is not ported to "
                                      "panogrf_tpu_torch yet")


def build(args: argparse.Namespace, log_fn=None) -> tuple:
    """(trainer, batch iterator, number of steps) for ``args``; ``log_fn``
    (step, metrics) is called beside the printed log."""
    _refuse_unported(args)
    dev = resolve_device(args.device)
    H, W = args.height, args.width
    loss = "gaussian_nll" if args.uncertainty else args.loss
    model = select_mono({"mono_net": args.mono_net,
                         "max_depth": args.max_depth,
                         "mono_uncertainty": args.uncertainty,
                         "mono_num_layers": args.num_layers,
                         "nrows": args.nrows,
                         "patchsize": args.patch_size})
    init_parameters_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    # UniFuse and the Cube ablation read the cubemap input
    with_cube = args.mono_net in ("UniFuse", "Cube")
    rng = np.random.default_rng(2022)

    def make_batch() -> dict:
        eqs, gts = [], []
        for _ in range(args.batch):
            scene = SphereScene.random(int(rng.integers(1 << 30)),
                                       device=dev)
            s = make_three_view_sample(scene, H, W, 0.5,
                                       seed=int(rng.integers(1 << 30)))
            eqs.append(s["rgb_panos"][1])
            gts.append(torch.clamp(s["depth_panos"][1], 0, args.max_depth))
        equi = normalize_imagenet(torch.stack(eqs))
        batch = {"equi": equi, "gt_depth": torch.stack(gts)}
        if with_cube:
            batch["cube"] = cubemap.equi_to_cube(equi, H // 2)
        return batch

    def batches():
        while True:
            yield make_batch()

    # the JAX tool draws one batch to initialise its net before training;
    # drawing it here too keeps the two streams of scenes the same
    make_batch()

    def forward_fn(batch: dict) -> dict:
        if with_cube:
            return model(batch["equi"], batch["cube"])
        return model(batch["equi"])

    print(f"{args.mono_net} params: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    cfg = DepthTrainConfig(name=args.name, learning_rate=args.lr,
                           loss_type=loss, aux_d1_weight=0.0,
                           log_interval=args.log_interval,
                           vis_interval=args.vis_interval)

    def log(step, m):
        print(f"step {step}: {m}", flush=True)
        if log_fn is not None:
            log_fn(step, m)

    trainer = DepthTrainer(model, forward_fn, cfg, log_fn=log)
    return trainer, batches(), args.steps


def main(argv=None, log_fn=None) -> DepthTrainer:
    """Run the CLI on ``argv``; returns the trained ``DepthTrainer``."""
    trainer, stream, steps = build(parse_args(argv), log_fn)
    trainer.restore()
    trainer.fit(stream, steps)
    print(f"saved {trainer.save()}")
    print("eval:", trainer.evaluate(stream, 2))
    return trainer


if __name__ == "__main__":
    main()
