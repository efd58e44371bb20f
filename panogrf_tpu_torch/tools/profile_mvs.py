"""Stage-level profile of the MVS depth training step on one GPU.

    python -m panogrf_tpu_torch.tools.profile_mvs [--height 256] \\
        [--width 512] [--batch 2] [--hypotheses 64] [--stages step,fwd,...]
        [--iters 3] [--scatter] [--device cpu]

Port of the repo's ``tools/profile_mvs.py``, with its flags, stages and
JSON keys (ms).  It attributes the two-view MVS training step of
``train/depth_trainer.DepthTrainer`` (l1-sphere loss) across its stages,
on random inputs from seed 2022 and random weights:

* ``step``: one whole ``train_step`` (forward, loss, backward, clipping,
  Adam; BatchNorm on batch statistics): the median of the ``--iters``
  intervals between step ends, as ``tools/bench_train`` times them;
* ``fwd``: the net's forward alone (eval mode);
* ``feat`` / ``feat_grad``: the ``Equi`` feature net on the 2B views,
  forward, and forward plus the gradient with respect to its input;
* ``sweep`` / ``sweep_grad``: the spherical sweep cost volume of the
  reference and source features, forward, and forward plus the gradient
  with respect to both feature maps;
* ``reg`` / ``reg_grad``: the ``UNet3D`` regulariser (base 32, 3 layers,
  wrap) on that cost volume, forward, and forward plus the gradient with
  respect to it.

The gradient stages take no optimizer work, as ``jax.grad`` in the JAX
tool.  Each stage but ``step`` is iterated ``--iters`` times on its own
output (``_stage_timer``): as one CUDA graph timed by events, or, where
``<stage>_timing`` says ``events``, eagerly between CUDA events.  The
JSON also carries ``sweep_backward`` (``scatter``), ``device``, ``tf32``
and each stage's ``mlp2`` launches (0: no stage of the depth net calls
the kernel).  It runs on the CUDA device and raises without one unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import copy
import itertools
import json
import statistics

import numpy as np
import torch

from panogrf_tpu_torch.models.mvs import MVSDepthModel, build_depth_hypotheses
from panogrf_tpu_torch.nn.blocks import init_parameters_, resize_linear
from panogrf_tpu_torch.ops.cost_volume import batched_sweep_cost
from panogrf_tpu_torch.tools._stage_timer import (EVENTS, GRAPH, Stage,
                                                  device_name, time_stages,
                                                  tf32_on)
from panogrf_tpu_torch.tools.bench_train import StepClock
from panogrf_tpu_torch.train.depth_trainer import (DepthTrainConfig,
                                                   DepthTrainer)
from panogrf_tpu_torch.utils.device import resolve_device

STAGES = ("step", "fwd", "feat", "feat_grad", "sweep", "sweep_grad", "reg",
          "reg_grad")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--hypotheses", type=int, default=64)
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--scatter", action="store_true",
                    help="accepted for the JAX tool's command lines; no "
                         "effect: the port's sweep has one backward, "
                         "autograd's scatter over the sampled points "
                         "(ops/cost_volume.py:10-16), which the JAX tool's "
                         "--scatter selects and its default replaces by "
                         "one-hot matmuls")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def mvs_inputs(hw: tuple, batch: int) -> dict:
    """The JAX tool's random batch as numpy (seed 2022, its order)."""
    h, w = hw
    rng = np.random.default_rng(2022)
    trans = np.zeros((batch, 2, 3))
    trans[:, 0, 2] = 0.3
    return {"panos": rng.uniform(size=(batch, 2, h, w, 3)),
            "rots": np.tile(np.eye(3), (batch, 2, 1, 1)), "trans": trans,
            "mono": rng.uniform(1, 5, size=(batch, h, w, 1)),
            "feat": rng.uniform(size=(batch, h // 2, w // 2, 32)),
            "gt_depth": rng.uniform(1, 5, size=(batch, h, w, 1))}


def mvs_model(hypotheses: int, dev: torch.device) -> MVSDepthModel:
    """The MVS net with seeded random weights, in eval mode."""
    model = MVSDepthModel(num_hypotheses=hypotheses)
    init_parameters_(model, torch.Generator().manual_seed(0))
    return model.to(dev).eval()


def _batch(inputs: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
            for k, v in inputs.items()}


def _forward(model: MVSDepthModel, b: dict) -> dict:
    out = model(b["panos"], b["rots"], b["trans"], b["mono"], b["feat"])
    out["pred_depth"] = out.pop("depth")
    return out


def _grads(fn, *xs) -> tuple:
    """d sum(fn(*xs)) / d xs, in a graph of its own."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in xs]
        return torch.autograd.grad(fn(*xs).sum(), xs)


def _chain(x, out) -> torch.Tensor:
    """The next scalar of a stage's chain: x (1 + 1e-9 sum(outputs))."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return x * (1.0 + 1e-9 * sum(o.sum() for o in outs))


def mvs_stages(model: MVSDepthModel, inputs: dict, dev: torch.device,
               iters: int = 3, stages=STAGES) -> dict:
    """{key: Stage} of the wanted stages but ``step`` on ``model`` (eval
    mode) and the batch ``inputs``; each stage's input is a scalar folded
    into its operands, its outputs what the tests compare."""
    b = _batch(inputs, dev)
    bsz, _, h, w, _ = b["panos"].shape
    h4, w4 = h // 4, w // 4
    flat = b["panos"].reshape(bsz * 2, h, w, 3)
    equi, u3 = model.unet, model.unet3d
    x0 = torch.ones((), device=dev)
    out = {}

    def stage(key, run, method=GRAPH):
        if key in stages:
            out[key] = Stage(run, _chain, x0, iters, method)

    # the forward builds its hypotheses' offsets from a host array
    # (``models/mvs.build_depth_hypotheses``): eager
    stage("fwd", lambda x: _forward(model, {**b, "panos": b["panos"]
                                            + x * 1e-12})["pred_depth"],
          EVENTS)
    stage("feat", lambda x: equi(flat + x * 1e-12))
    stage("feat_grad", lambda x: _grads(equi, flat + x * 1e-12))
    with torch.no_grad():
        feats = equi(flat).reshape(bsz, 2, h4, w4, -1)
        mu4 = resize_linear(b["mono"], (h4, w4), axes=(1, 2))
        dvol = build_depth_hypotheses(mu4, [0.0] * 5, model.num_hypotheses,
                                      0.1, 10.0, 0.5)

    def sweep(rf, sf):
        return batched_sweep_cost(rf, sf, dvol, b["rots"], b["trans"],
                                  model.convention)
    ref, src = feats[:, 1], feats[:, 0]
    stage("sweep", lambda x: sweep(ref + x * 0, src + x * 0))
    stage("sweep_grad", lambda x: _grads(sweep, ref + x * 0, src + x * 0))
    with torch.no_grad():
        cost = sweep(ref, src).permute(0, 4, 1, 2, 3).contiguous()
    stage("reg", lambda x: u3(cost + x * 0))
    stage("reg_grad", lambda x: _grads(u3, cost + x * 0))
    return out


def step_ms(model: MVSDepthModel, inputs: dict, dev: torch.device,
            iters: int = 3) -> tuple:
    """(ms of each of ``iters`` training steps after a warm-up, the
    losses of all ``iters`` + 1, their ``mlp2`` launches) of a copy of
    ``model``."""
    net = copy.deepcopy(model)
    clock = StepClock(dev)
    trainer = DepthTrainer(net, lambda b: _forward(net, b),
                           DepthTrainConfig(loss_type="l1_sphere",
                                            log_interval=1), log_fn=clock)
    trainer.fit(itertools.repeat(_batch(inputs, dev)), iters + 1)
    return clock.ms(), clock.losses, clock.launches


def main(argv=None) -> dict:
    """Profile the stages on ``argv``; prints the JSON and returns it."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    stages = args.stages.split(",")
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise SystemExit(f"unknown stages {sorted(unknown)}; choose from "
                         f"{','.join(STAGES)}")
    inputs = mvs_inputs((args.height, args.width), args.batch)
    model = mvs_model(args.hypotheses, dev)
    res = {"mlp2_launches": {}}
    if "step" in stages:
        print("[stage] step ...", flush=True)
        runs, _, launches = step_ms(model, inputs, dev, args.iters)
        res.update(step=statistics.median(runs), step_timing=EVENTS)
        res["mlp2_launches"]["step"] = max(launches)
    with torch.no_grad():
        time_stages(mvs_stages(model, inputs, dev, args.iters, stages), dev,
                    res)
    res.update(sweep_backward="scatter", device=device_name(dev),
               tf32=tf32_on())
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
