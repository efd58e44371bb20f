"""Training-throughput benchmark: ms per step of the two training recipes.

    python -m panogrf_tpu_torch.tools.bench_train [--recipe gen|mvs|all] \\
        [--iters 10] [--rays 512] [--mesh N] [--device cpu]

Port of the repo's ``tools/bench_train.py``:

* ``gen``: the 512x1024 renderer recipe, 512 query rays a step, 64 + 64
  samples, 2 reference views, render + depth losses, Adam with exp-decay
  (``train.trainer.Trainer``);
* ``mvs``: the 256x512 two-view MVS depth recipe at batch 2 with 64
  hypotheses, l1-sphere + 0.5 x the d1 term (``train.depth_trainer.
  DepthTrainer``).

Each recipe trains ``--iters`` + 1 steps on one fixed batch (the first is
the warm-up) and prints ONE JSON line: ``value`` is the median ms per step
of the intervals between consecutive step ends, timed with CUDA events on
the card, with the ``runs``, their ``spread``, the losses, the ``mlp2``
kernel's launches per step and the device's name.  ``--mesh N`` times the
data-parallel variant on N ranks, one process each
(``parallel/launch.run_ranks``: the gen recipe's rays or the MVS batch
split over the ranks; rank 0's times).  It runs on the CUDA device and
raises without one unless ``--device cpu`` is given; on the CPU the
recipes run at 64x128 and 32x64 (16 hypotheses).
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import time

import numpy as np
import torch

from panogrf_tpu_torch.data import imgs_info
from panogrf_tpu_torch.data.synthetic import (SphereScene,
                                              make_three_view_sample)
from panogrf_tpu_torch.models.mvs import MVSDepthModel
from panogrf_tpu_torch.nn.blocks import (init_parameters_, resize_linear,
                                         set_bn_axis)
from panogrf_tpu_torch.ops.kernels import fused_mlp
from panogrf_tpu_torch.parallel.launch import run_ranks
from panogrf_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh
from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
from panogrf_tpu_torch.train.depth_trainer import (DepthTrainConfig,
                                                   DepthTrainer)
from panogrf_tpu_torch.train.trainer import Trainer, TrainerConfig
from panogrf_tpu_torch.utils.device import resolve_device, synchronize


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recipe", default="gen", choices=["gen", "mvs", "all"])
    ap.add_argument("--iters", type=int, default=10,
                    help="timed steps after the warm-up step")
    ap.add_argument("--rays", type=int, default=512)
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="train on N ranks, one card each (--device cpu: N "
                         "CPU processes)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


class StepClock:
    """The trainers' ``log_fn``: at each step end it waits for the device,
    records a CUDA event (the host clock on the CPU), the loss and the
    step's ``mlp2`` launches (all, and of the ``lanes`` variant)."""

    def __init__(self, dev: torch.device):
        self.dev, self.ends, self.losses = dev, [], []
        self.launches, self.lanes = [], []
        fused_mlp.reset_launches()

    def __call__(self, step, metrics) -> None:
        synchronize(self.dev)
        if self.dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.ends.append(ev)
        else:
            self.ends.append(time.perf_counter())
        self.losses.append(metrics["loss"])
        self.launches.append(fused_mlp.MLP2_LAUNCHES)
        self.lanes.append(fused_mlp.VARIANT_LAUNCHES["mlp2_lanes"])
        fused_mlp.reset_launches()

    def ms(self) -> list:
        pairs = zip(self.ends, self.ends[1:])
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


def _row(name: str, clock: StepClock, dev: torch.device, mesh,
         **extra) -> dict | None:
    """The recipe's JSON row; None on a rank other than 0, whose trainer
    logs nothing."""
    if not clock.ends:
        return None
    runs = clock.ms()
    ms = statistics.median(runs)
    if "rays_per_step" in extra:
        extra["rays_per_sec"] = extra["rays_per_step"] / (ms / 1e3)
    return {"metric": name + ("_cpu" if dev.type == "cpu" else ""),
            "value": ms, "unit": "ms/step", "steps_per_sec": 1e3 / ms,
            "runs": runs, "spread": max(runs) - min(runs),
            "losses": clock.losses, "mlp2_launches_per_step": clock.launches,
            "mlp2_lanes_launches_per_step": clock.lanes,
            "ranks": mesh.size if mesh is not None else 1,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu", **extra}


def bench_gen(args, dev: torch.device, mesh=None) -> dict:
    on_cpu = dev.type == "cpu"
    H, W = (64, 128) if on_cpu else (512, 1024)
    DH, DW = (32, 64) if on_cpu else (256, 512)
    model = NeuralRayGenRenderer(height=H, width=W, depth_hw=(DH, DW),
                                 gather_depth_major=True, device=dev,
                                 generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2022)
    s = make_three_view_sample(SphereScene.random(7, device=dev), H, W, 0.5,
                               seed=7)
    coords = imgs_info.sample_train_coords(rng, H, W, args.rays, device=dev)
    data = imgs_info.build_render_sample(s, coords, (0.5, 15.0),
                                         src_for_mvs=False)
    ref = list(imgs_info.REF_IDS)
    data["ref_imgs_info"]["mvs_depth"] = resize_linear(
        s["depth_panos"][ref], (DH, DW), axes=(1, 2))
    # the recipe's depth loss reads the references' true depth
    data["ref_imgs_info"]["true_depth"] = s["depth_panos"][ref]
    clock = StepClock(dev)
    trainer = Trainer(model, lambda b, g: model(b, g),
                      TrainerConfig(losses=("render", "depth"),
                                    log_interval=1),
                      log_fn=clock, mesh=mesh)
    trainer.fit(itertools.repeat(data), args.iters + 1)
    return _row(f"torch_train_gen_{H}x{W}", clock, dev, mesh,
                rays_per_step=args.rays)


def bench_mvs(args, dev: torch.device, mesh=None) -> dict:
    on_cpu = dev.type == "cpu"
    H, W = (32, 64) if on_cpu else (256, 512)
    B = 2
    model = MVSDepthModel(num_hypotheses=16 if on_cpu else 64)
    init_parameters_(model, torch.Generator().manual_seed(0))
    model.to(dev)
    if mesh is not None:
        set_bn_axis(model, DATA_AXIS, mesh)
    rng = np.random.default_rng(2022)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    trans = np.zeros((B, 2, 3))
    trans[:, 0, 2] = 0.3
    batch = {"panos": t(rng.uniform(size=(B, 2, H, W, 3))),
             "rots": t(np.tile(np.eye(3), (B, 2, 1, 1))),
             "trans": t(trans),
             "mono": t(rng.uniform(1, 5, size=(B, H, W, 1))),
             "feat": t(rng.uniform(size=(B, H // 2, W // 2, 32))),
             "gt_depth": t(rng.uniform(1, 5, size=(B, H, W, 1)))}

    def forward_fn(b):
        out = model(b["panos"], b["rots"], b["trans"], b["mono"], b["feat"])
        out["pred_depth"] = out.pop("depth")
        return out

    clock = StepClock(dev)
    trainer = DepthTrainer(model, forward_fn,
                           DepthTrainConfig(loss_type="l1_sphere",
                                            log_interval=1),
                           log_fn=clock, mesh=mesh)
    trainer.fit(itertools.repeat(batch), args.iters + 1)
    return _row(f"torch_train_mvs_{H}x{W}_b{B}", clock, dev, mesh, batch=B,
                hypotheses=model.num_hypotheses)


def run(args: argparse.Namespace, ranked: bool = False) -> list:
    """The chosen recipes' rows; ``ranked``: this rank's, on meshes over
    the launcher's ranks (the gen recipe's rays, the MVS batch)."""
    gen_mesh = make_mesh(args.mesh, device=args.device) if ranked else None
    mvs_mesh = make_mesh(args.mesh, data=args.mesh, device=args.device) \
        if ranked else None
    dev = gen_mesh.device if ranked else resolve_device(args.device)
    rows = []
    if args.recipe in ("gen", "all"):
        rows.append(bench_gen(args, dev, gen_mesh))
    if args.recipe in ("mvs", "all"):
        rows.append(bench_mvs(args, dev, mvs_mesh))
    return rows


def run_rank(args: argparse.Namespace) -> list:
    """One rank of ``--mesh``."""
    return run(args, ranked=True)


def main(argv=None) -> list:
    """Run the benchmark on ``argv``; prints one JSON line per recipe and
    returns the rows."""
    args = parse_args(argv)
    if args.mesh:
        if args.recipe in ("gen", "all") and args.rays % args.mesh:
            raise SystemExit(f"--mesh {args.mesh} must divide the "
                             f"{args.rays} rays of a step")
        if args.recipe in ("mvs", "all") and 2 % args.mesh:
            raise SystemExit(f"--mesh {args.mesh} must divide the MVS "
                             "recipe's batch of 2")
        rows = run_ranks(run_rank, args.mesh, args.device, (args,))
    else:
        rows = run(args)
    for row in rows:
        print(json.dumps(row))
    return rows


if __name__ == "__main__":
    main()
