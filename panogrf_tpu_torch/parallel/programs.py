"""Rank programs: picklable entry points for ``launch.run_ranks`` that run
one sharded operation of the port on every rank and return rank 0's
results as numpy, with each rank's ``mlp2`` launches.

The caller builds the module and the inputs (on the CPU); each rank moves
a copy to its device: the rank's card unless the caller passes
``device="cpu"`` (a world of 1 runs in the caller's process, whose module
stays as it was).  The programs compare nothing: the tests hold
their results against the JAX package and against a world of 1, and
``chip_smoke.py`` against a world of 1 on the card.  ``run_all`` runs
several in one group of ranks, which saves a spawn per program.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import time

import numpy as np
import torch
import torch.distributed as dist

from panogrf_tpu_torch.nn.blocks import set_bn_axis
from panogrf_tpu_torch.ops.kernels import fused_mlp
from panogrf_tpu_torch.parallel.mesh import (DATA_AXIS, gather_counts,
                                             make_mesh, place_depth_batch,
                                             pmean, sync_grads)
from panogrf_tpu_torch.parallel.sharded_render import render_image_sharded
from panogrf_tpu_torch.renderer import full_render
from panogrf_tpu_torch.train.depth_trainer import DepthTrainer
from panogrf_tpu_torch.train.trainer import Trainer
from panogrf_tpu_torch.utils.device import synchronize


def run_all(jobs: list) -> list:
    """Each ``(program, kwargs)`` of ``jobs`` in order; their results."""
    return [program(**kwargs) for program, kwargs in jobs]


def _mesh(device, data_parallel: bool):
    """This rank's mesh over the launcher's ranks; ``make_mesh`` raises on
    ``"cuda"`` without a card."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n, data=n if data_parallel else 1, device=device)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _tensors(tree, dev):
    if isinstance(tree, dict):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    return torch.as_tensor(tree, device=dev)


def _launches(mesh) -> dict:
    """Each rank's launches since the last reset, by kernel and variant."""
    return {"mlp2": gather_counts(fused_mlp.MLP2_LAUNCHES, mesh),
            "mlp2_lanes": gather_counts(
                fused_mlp.VARIANT_LAUNCHES["mlp2_lanes"], mesh),
            "mlp3": gather_counts(fused_mlp.MLP3_LAUNCHES, mesh)}


def param_grads(module: torch.nn.Module) -> dict:
    """The parameters' ``.grad`` (a step's, all-reduced), as numpy."""
    return {k: _numpy(p.grad) for k, p in module.named_parameters()
            if p.grad is not None}


def probe_loss(out) -> torch.Tensor:
    """A loss of a module's output(s) whose gradient reaches the
    BatchNorms' statistics: the sum over outputs of mean(sin(1.7 x +
    0.3))."""
    outs = out if isinstance(out, (list, tuple)) else [out]
    return sum(torch.mean(torch.sin(1.7 * o + 0.3)) for o in outs)


def bn_step(module: torch.nn.Module, x, device="cuda") -> dict:
    """One training-mode forward of ``module`` on this rank's share of
    ``x`` (its leading dimension split over the ranks) with cross-rank
    BatchNorm, and the gradient of ``probe_loss`` averaged over the ranks:
    the running statistics, the gradients and the loss."""
    mesh = _mesh(device, True)
    module = set_bn_axis(copy.deepcopy(module).to(mesh.device).train(),
                         DATA_AXIS, mesh)
    xs = place_depth_batch(mesh, {"x": torch.as_tensor(x)})["x"]
    loss = probe_loss(module(xs.to(mesh.device)))
    loss.backward()
    sync_grads(list(module.parameters()), mesh, DATA_AXIS, mean=True)
    return {"loss": float(pmean(loss.detach(), mesh, DATA_AXIS)),
            "state": _numpy(module.state_dict()),
            "grads": param_grads(module)}


def depth_steps(model: torch.nn.Module, batch: dict, cfg, inputs: tuple,
                device="cuda", steps: int = 1) -> dict:
    """``steps`` data-parallel ``DepthTrainer`` steps (cross-rank
    BatchNorm) of ``model`` on the whole ``batch`` each step, the forward
    ``model(*batch[k] for k in inputs)``: the losses, the state dict
    after them, the first step's gradients, the ms of each step after the
    first (host clock) and each rank's kernel launches."""
    mesh = _mesh(device, True)
    model = set_bn_axis(copy.deepcopy(model).to(mesh.device), DATA_AXIS,
                        mesh)
    batch = _tensors(batch, mesh.device)
    log, times, grads = [], [], []

    def on_step(step, metrics):
        synchronize(mesh.device)
        times.append(time.perf_counter())
        log.append(metrics["loss"])
        if not grads:
            grads.append(param_grads(model))
    trainer = DepthTrainer(model, lambda b: model(*(b[k] for k in inputs)),
                           dataclasses.replace(cfg, log_interval=1),
                           log_fn=on_step, mesh=mesh)
    fused_mlp.reset_launches()
    trainer.fit(itertools.repeat(batch), steps)
    return {"losses": log, "state": _numpy(model.state_dict()),
            "grads": grads[0] if grads else None,
            "ms": list(np.diff(times) * 1e3), "launches": _launches(mesh)}


def renderer_steps(model: torch.nn.Module, batch: dict, cfg,
                   device="cuda", steps: int = 1) -> dict:
    """``steps`` renderer ``Trainer`` steps of ``model`` with the rays of
    the whole ``batch`` split over the ranks (the same batch each step,
    the generator seeded with ``cfg.seed``): each step's metrics, the
    state dict after them, the first step's gradients, the ms of each
    step after the first (host clock) and each rank's kernel launches
    over the steps."""
    mesh = _mesh(device, False)
    model = copy.deepcopy(model).to(mesh.device)
    batch = _tensors(batch, mesh.device)
    log, times, grads = [], [], []

    def on_step(step, metrics):
        synchronize(mesh.device)
        times.append(time.perf_counter())
        log.append(metrics)
        if not grads:
            grads.append(param_grads(model))
    trainer = Trainer(model, lambda b, g: model(b, g),
                      dataclasses.replace(cfg, log_interval=1),
                      log_fn=on_step, mesh=mesh)
    fused_mlp.reset_launches()
    trainer.fit(itertools.repeat(batch), steps)
    return {"metrics": [_numpy(m) for m in log],
            "state": _numpy(model.state_dict()),
            "grads": grads[0] if grads else None,
            "ms": list(np.diff(times) * 1e3), "launches": _launches(mesh)}


def render_frame(model: torch.nn.Module, ref_info: dict, que_c2w,
                 que_depth_range, device="cuda", coarse_lowres: int = 1,
                 chunk: int = 8192, coarse_chunk: int = 0,
                 repeat: int = 1) -> dict:
    """A panorama by ``render_image_sharded``, ``repeat`` times after one
    warm-up frame: the image, the ms of each timed frame (host clock) and
    each rank's kernel launches in the last frame."""
    mesh = _mesh(device, False)
    model = copy.deepcopy(model).to(mesh.device).eval()
    ref_data = full_render.prepare_ref_data(model, ref_info,
                                            device=mesh.device)
    ms = []
    for i in range(repeat + 1):
        fused_mlp.reset_launches()
        synchronize(mesh.device)
        t0 = time.perf_counter()
        rgb = render_image_sharded(model, ref_data, que_c2w,
                                   que_depth_range, ref_info["depth_range"],
                                   mesh, coarse_lowres, chunk, coarse_chunk)
        synchronize(mesh.device)
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    return {"rgb": _numpy(rgb), "ms": ms, "launches": _launches(mesh)}
