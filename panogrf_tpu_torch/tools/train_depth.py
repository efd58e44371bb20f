"""Train the 360-degree MVS depth net on a frozen mono prior.

    python -m panogrf_tpu_torch.tools.train_depth [--cfg <yaml>] \\
        [--steps N] [--height H --width W] [--views V] [--shards DIR] \\
        [--mono-ckpt F] [--mvs-uncertainty] [--new-reg3dnet] \\
        [--model mvs|fnet] [--mesh N] [--device cpu]

Port of the repo's ``tools/train_depth.py``.  A recipe yaml (``--cfg``,
e.g. ``configs/depth/m3d_mvs.yaml``) supplies height, width, views,
batch, lr, view spacing, depth range, hypotheses and run name; a flag
given on the command line wins over it.  Each step draws ``--batch``
procedural scenes from ``np.random.default_rng(2022)`` and renders them
on the device (the 3-view sample for V <= 3, else the V-view sample), or
with ``--shards`` draws random samples of the shard directory (which must
hold at least V views each).  Views are ordered [0, 1] for 2 views and
[0, V-1, 1, ..., V-2] otherwise, so index 1 is the reference view whose depth (clipped to ``--max-depth``) is
supervised and every other index a source.  The frozen UniFuse prior runs
on the reference view in eval mode under ``torch.inference_mode`` and
gives the MVS net its mono depth and features.  The MVS net (its 3D
UNet, or MVSNet's ``CostRegNet`` with ``--new-reg3dnet``) trains with the
sin-weighted L1 (Gaussian NLL with ``--mvs-uncertainty``) plus half the
L1 of its 1/4-res head, Adam at a constant lr behind an element-wise
gradient clip of 1 (``train/depth_trainer.py``).  ``--model fnet`` trains
the single-UNet ``FNetDepthModel`` instead, on views 0 and 1 with
``--hypotheses`` inverse-uniform depths and no mono prior.

``--mono-ckpt`` is a mono checkpoint file of ``train_mono`` (or any
reference-layout UniFuse file, or an MVS file's ``d_net.*``); without it
the prior has random weights.  Checkpoints land in
``data/depth_model/<name>/checkpoint_<step>.pth`` with the MVS net's
prior under ``d_net.*``.  The run resumes from the newest checkpoint of
``<name>``, then prints the ERP depth metrics of 2 more batches.  It runs
on the CUDA device and raises without one unless ``--device cpu`` is
given.

``--mesh N`` trains data-parallel on N ranks, one process each
(``parallel/launch.run_ranks``: NCCL on N cards, gloo on the CPU with
``--device cpu``), with cross-rank BatchNorm in the trained net: every
rank draws the same batches, runs the frozen prior on them outside the
step, and trains on its ``--batch`` / N samples, which must divide; rank
0 prints, writes the checkpoints and sheets and evaluates.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from panogrf_tpu_torch.config import load_config
from panogrf_tpu_torch.core import cubemap
from panogrf_tpu_torch.data.shards import ShardReader, sample_to_torch
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_multi_view_sample,
                                              make_three_view_sample)
from panogrf_tpu_torch.models.depth_stack import (extract_dnet,
                                                  load_reference_state,
                                                  read_checkpoint)
from panogrf_tpu_torch.models.fnet import FNetDepthModel
from panogrf_tpu_torch.models.mvs import MVSDepthModel
from panogrf_tpu_torch.models.unifuse import UniFuse, normalize_imagenet
from panogrf_tpu_torch.nn.blocks import init_parameters_, set_bn_axis
from panogrf_tpu_torch.parallel.launch import run_ranks
from panogrf_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from panogrf_tpu_torch.parallel.programs import param_grads
from panogrf_tpu_torch.train.depth_trainer import (DepthTrainConfig,
                                                   DepthTrainer)
from panogrf_tpu_torch.utils.device import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cfg", default=None,
                    help="depth recipe yaml (e.g. configs/depth/"
                         "m3d_mvs.yaml); flags given here override it")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--views", type=int, default=2, metavar="V",
                    help="V-view MVS: the reference's cost is averaged over "
                         "the V-1 sources")
    ap.add_argument("--shards", default=None,
                    help="train on this shard directory's samples instead "
                         "of procedural scenes")
    ap.add_argument("--mono-ckpt", default=None,
                    help="frozen mono prior: a train_mono checkpoint file")
    ap.add_argument("--m3d-dist", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--name", default="mvs_run")
    ap.add_argument("--min-depth", type=float, default=0.1)
    ap.add_argument("--max-depth", type=float, default=10.0)
    ap.add_argument("--hypotheses", type=int, default=64)
    ap.add_argument("--mvs-uncertainty", action="store_true")
    ap.add_argument("--model", default="mvs", choices=["mvs", "fnet"],
                    help="mvs = 360-MVSNet on the mono prior; fnet = the "
                         "single-UNet cost-volume net, no mono prior")
    ap.add_argument("--new-reg3dnet", action="store_true",
                    help="MVSNet's CostRegNet regulariser in place of the "
                         "3D UNet")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="train data-parallel on N ranks (one card each; "
                         "--device cpu: N CPU processes) with cross-rank "
                         "BatchNorm; --batch must be a multiple of N")
    ap.add_argument("--vis-interval", type=int, default=100,
                    help="write rgb|gt|pred|error turbo sheets every N "
                         "steps (0 = off)")
    ap.add_argument("--log-interval", type=int, default=10,
                    help="print the loss every N steps (and after step 1)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.cfg:
        # the recipe supplies the defaults; flags given explicitly win
        cfg = load_config(args.cfg)
        given = {a.split("=")[0].lstrip("-").replace("-", "_")
                 for a in argv if a.startswith("--")}
        for flag, val in [
                ("height", cfg.data.height), ("width", cfg.data.width),
                ("views", cfg.data.seq_len),
                ("batch", cfg.train.batch_size), ("lr", cfg.train.lr_init),
                ("m3d_dist", cfg.data.m3d_dist),
                ("min_depth", cfg.mono.min_depth),
                ("max_depth", cfg.mono.max_depth),
                ("hypotheses", cfg.mvs.cost_volume_channels),
                ("name", cfg.train.name)]:
            if flag not in given:
                setattr(args, flag, val)
    return args


def view_order(views: int) -> list:
    """Index 1 is the reference, every other index a source: [0, 1] for
    2 views, [0, V-1, 1, ..., V-2] for V > 2."""
    v = max(2, views)
    return [0, 1] if v == 2 else [0, v - 1] + list(range(1, v - 1))


def load_mono(path: str | None, max_depth: float, device) -> UniFuse:
    """The frozen UniFuse prior in eval mode: weights from ``path`` (a mono
    checkpoint, or an MVS checkpoint's ``d_net.*``), else seeded."""
    mono = UniFuse(max_depth=max_depth)
    init_parameters_(mono, torch.Generator().manual_seed(1))
    if path:
        sd = read_checkpoint(path)
        load_reference_state(mono, extract_dnet(sd) or sd)
        print(f"restored mono from {path}")
    return mono.requires_grad_(False).eval().to(device)


def build(args: argparse.Namespace, log_fn=None, mesh=None) -> tuple:
    """(trainer, batch iterator, number of steps) for ``args``; ``log_fn``
    (step, metrics) is called beside the printed log.  With a ``mesh``
    (``parallel.mesh.Mesh``) the trainer trains data-parallel over it, on
    this rank's device."""
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    H, W = args.height, args.width
    fnet = args.model == "fnet"
    mono = None if fnet else load_mono(args.mono_ckpt, args.max_depth, dev)
    rng = np.random.default_rng(2022)
    reader = ShardReader(args.shards) if args.shards else None
    order = view_order(args.views)
    V = len(order)

    @torch.inference_mode()
    def mono_prior(ref: torch.Tensor) -> tuple:
        equi = normalize_imagenet(ref)
        out = mono(equi, cubemap.equi_to_cube(equi, H // 2))
        return out["pred_depth"], out["mono_feat"]

    def make_batch() -> dict:
        samples = []
        for _ in range(args.batch):
            if reader is not None:
                s = reader[int(rng.integers(len(reader)))]
                if s["rgb_panos"].shape[0] < V:
                    raise SystemExit(
                        f"--views {V} but data has "
                        f"{s['rgb_panos'].shape[0]} views per sample")
                s = sample_to_torch(s, dev)
            else:
                scene = SphereScene.random(int(rng.integers(1 << 30)),
                                           device=dev)
                seed = int(rng.integers(1 << 30))
                if V <= 3:
                    s = make_three_view_sample(scene, H, W, args.m3d_dist,
                                               seed)
                else:
                    s = make_multi_view_sample(scene, H, W, V,
                                               args.m3d_dist, seed)
            samples.append(s)
        batch = {k: torch.stack([s[k][order] for s in samples])
                 for k in ("rgb_panos", "rots", "trans")}
        batch = {"panos": batch["rgb_panos"], "rots": batch["rots"],
                 "trans": batch["trans"],
                 "gt_depth": torch.stack([torch.clamp(
                     s["depth_panos"][order[1]], 0, args.max_depth)
                     for s in samples])}
        if mono is not None:
            # inference tensors become ordinary ones for the autograd graph
            batch["mono_depth"], batch["mono_feat"] = (
                t.clone() for t in mono_prior(batch["panos"][:, 1]))
        return batch

    def batches():
        while True:
            yield make_batch()

    # the JAX tool draws one batch to initialise its net before training;
    # drawing it here too keeps the two streams of scenes the same
    make_batch()
    if fnet:
        model = FNetDepthModel(min_depth=args.min_depth,
                               max_depth=args.max_depth,
                               num_depths=args.hypotheses)
    else:
        model = MVSDepthModel(min_depth=args.min_depth,
                              max_depth=args.max_depth,
                              num_hypotheses=args.hypotheses,
                              mvs_uncertainty=args.mvs_uncertainty,
                              use_new_reg3dnet=args.new_reg3dnet)
    init_parameters_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    if mesh is not None:
        set_bn_axis(model, DATA_AXIS, mesh)

    def forward_fn(batch: dict) -> dict:
        if fnet:
            out = model(batch["panos"][:, :2], batch["rots"][:, :2],
                        batch["trans"][:, :2])
            return {"pred_depth": out["depth"]}
        out = model(batch["panos"], batch["rots"], batch["trans"],
                    batch["mono_depth"], batch["mono_feat"])
        out["pred_depth"] = out.pop("depth")
        if args.mvs_uncertainty:
            out["pred"] = out["pred_final"]
        return out

    print(f"{args.model} params: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    cfg = DepthTrainConfig(
        name=args.name, learning_rate=args.lr,
        loss_type="gaussian_nll" if args.mvs_uncertainty else "l1_sphere",
        log_interval=args.log_interval, vis_interval=args.vis_interval)

    def log(step, m):
        print(f"step {step}: {m}", flush=True)
        if log_fn is not None:
            log_fn(step, m)

    trainer = DepthTrainer(model, forward_fn, cfg, log_fn=log,
                           frozen={} if fnet else {"d_net": mono}, mesh=mesh)
    return trainer, batches(), args.steps


def run(args: argparse.Namespace, log_fn=None, mesh=None) -> DepthTrainer:
    """Build, restore, train, save and evaluate (rank 0) as the CLI does."""
    return train(*build(args, log_fn, mesh))


def train(trainer: DepthTrainer, stream, steps: int) -> DepthTrainer:
    """Restore, train, save and evaluate (rank 0) as the CLI does."""
    trainer.restore()
    trainer.fit(stream, steps)
    print(f"saved {trainer.save()}")
    if trainer.is_chief:
        print("eval:", trainer.evaluate(stream, 2))
    return trainer


def run_rank(args: argparse.Namespace, log_fn=None) -> dict:
    """``run`` on the mesh of ``args.mesh`` ranks (one rank of ``--mesh``),
    or without a mesh when ``args.mesh`` is 0; returns the last step, its
    checkpoint, the logged losses and the first step's clipped gradients
    (with a mesh, the ranks' mean) as numpy."""
    record = {"losses": [], "grads": None}

    def log(step, metrics):
        record["losses"].append(metrics["loss"])
        if record["grads"] is None:
            # ``trainer`` is bound below, before its first step
            record["grads"] = param_grads(trainer.model)
        if log_fn is not None:
            log_fn(step, metrics)
    mesh = make_mesh(args.mesh, data=args.mesh, device=args.device) \
        if args.mesh else None
    trainer, stream, steps = build(args, log, mesh)
    train(trainer, stream, steps)
    return {"step": trainer.step, **record, "checkpoint": str(
        trainer.root / f"checkpoint_{trainer.step}.pth")}


def main(argv=None, log_fn=None):
    """Run the CLI on ``argv``; returns the trained ``DepthTrainer``, or
    with ``--mesh`` rank 0's ``run_rank`` result (``log_fn`` must then be
    picklable, unless N is 1)."""
    args = parse_args(argv)
    if args.mesh:
        if args.batch % args.mesh:
            raise SystemExit(f"--batch {args.batch} must be a multiple of "
                             f"--mesh {args.mesh}")
        return run_ranks(run_rank, args.mesh, args.device, (args, log_fn))
    return run(args, log_fn)


if __name__ == "__main__":
    main()
