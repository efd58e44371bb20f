"""Step-based renderer trainer (Adam + lr schedule), port of
``panogrf_tpu/train/trainer.py``.

What follows the JAX package (optax):

* ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999, eps 1e-8);
  update k (from 0) uses the schedule's lr at k, as ``optax.adam(schedule)``
  reads its count;
* optional global-norm clipping by optax's formula, every gradient scaled
  by ``max_norm / max(norm, max_norm)``;
* count-jitter: with a dict of forward functions sharing one model, each
  step draws its variant with ``np.random.default_rng(cfg.seed)`` exactly
  as the JAX trainer does;
* checkpoints in the reference ``model.pth`` layout ``{step, best_para,
  network_state_dict, optimizer_state_dict}``, which the JAX package's
  ``load_checkpoint_params`` reads; restoring resumes the step and with it
  the lr.

The step's randomness comes from one CPU ``torch.Generator`` seeded with
``cfg.seed``, so a run on the card and a run on the CPU draw the same.

With a ``mesh`` (``parallel/mesh.py``) every rank runs the trainer on the
same stream of batches and the same generator, and each step renders the
rank's share of the rays (``make_train_step``); the parameters start from
rank 0's, and only rank 0 logs, validates and writes checkpoints;
``restore`` reads on rank 0 and broadcasts.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from panogrf_tpu_torch.parallel.mesh import (RAY_AXIS, Mesh,
                                             broadcast_object, psum,
                                             replicate_tree, shard_ray_batch,
                                             sync_grads)
from panogrf_tpu_torch.renderer.render_ops import RayShard
from panogrf_tpu_torch.train.losses import NAME2LOSS, total_loss
from panogrf_tpu_torch.train.lr import NAME2LR
from panogrf_tpu_torch.utils import from_jax
from panogrf_tpu_torch.utils.orbax_read import read_tree

ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


@dataclasses.dataclass
class TrainerConfig:
    name: str = "run"
    total_step: int = 100000
    val_interval: int = 10000
    save_interval: int = 20000
    lr_type: str = "exp_decay"
    lr_cfg: dict = dataclasses.field(default_factory=lambda: {
        "lr_init": 4e-4, "decay_step": 20000, "decay_rate": 0.5})
    losses: tuple = ("render",)
    loss_kwargs: dict = dataclasses.field(default_factory=dict)
    grad_clip: Optional[float] = None
    seed: int = 2022
    save_dir: str = "data/model"
    log_interval: int = 100


def make_optimizer(cfg: TrainerConfig, params) -> tuple:
    """(Adam over ``params``, schedule: update count -> lr)."""
    schedule = NAME2LR[cfg.lr_type](**cfg.lr_cfg)
    opt = torch.optim.Adam(params, lr=schedule(0), betas=ADAM_BETAS,
                           eps=ADAM_EPS)
    return opt, schedule


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale every gradient by max_norm / max(global norm, max_norm) in
    place (optax's ``clip_by_global_norm``); returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


def apply_update(opt: torch.optim.Optimizer, schedule: Callable, count: int,
                 grad_clip: Optional[float] = None) -> None:
    """Update ``count`` (from 0) on the parameters' ``.grad``: optional
    global-norm clipping, then Adam at the schedule's lr for ``count``."""
    if grad_clip:
        clip_by_global_norm_([p for g in opt.param_groups
                              for p in g["params"]], grad_clip)
    for group in opt.param_groups:
        group["lr"] = schedule(count)
    opt.step()


def make_loss_fn(cfg: TrainerConfig,
                 ray_sum: Optional[Callable] = None) -> Callable:
    """(outputs, batch) -> (total loss, dict of loss terms), summing every
    ``*loss*`` term of the configured losses; ``ray_sum`` goes to each
    loss when the batch's rays are split over processes."""
    extra = {} if ray_sum is None else {"ray_sum": ray_sum}
    loss_fns = [(NAME2LOSS[n], {**cfg.loss_kwargs.get(n, {}), **extra})
                for n in cfg.losses]

    def loss_fn(outputs: dict, batch: dict) -> tuple:
        terms = {}
        for fn, kw in loss_fns:
            terms.update(fn(outputs, batch, 0, **kw))
        return total_loss(terms), terms
    return loss_fn


def make_train_step(forward_fn: Callable, cfg: TrainerConfig,
                    opt: torch.optim.Optimizer, schedule: Callable,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Build ``step(batch, generator, count) -> metrics``: forward, losses,
    backward, optional clipping, then one Adam update at the schedule's
    lr for update ``count``.  After it, each parameter's ``.grad`` holds
    the (clipped) gradient of that step.

    ``forward_fn(batch, generator)`` returns the renderer's output dict.
    With a ``mesh`` each rank takes the whole ``batch`` and renders its
    share of the rays over the mesh's ray axis (``shard_ray_batch``; its
    draws through a ``render_ops.RayShard``); its losses are its share of
    the whole batch's (``ray_sum``), and the gradients and the metrics are
    summed over the ranks, so the step is the whole batch's on every rank.
    """
    ray_sum = None if mesh is None else (lambda x: psum(x, mesh, RAY_AXIS))
    loss_fn = make_loss_fn(cfg, ray_sum)
    params = [p for g in opt.param_groups for p in g["params"]]

    def train_step(batch: dict, generator: torch.Generator,
                   count: int) -> dict:
        if mesh is not None:
            batch = shard_ray_batch(mesh, batch)
            generator = RayShard(generator, mesh.shape[RAY_AXIS],
                                 mesh.axis_index(RAY_AXIS))
        opt.zero_grad(set_to_none=True)
        loss, terms = loss_fn(forward_fn(batch, generator), batch)
        loss.backward()
        if mesh is not None:
            sync_grads(params, mesh, RAY_AXIS, mean=False)
        apply_update(opt, schedule, count, cfg.grad_clip)
        values = torch.stack([loss.detach()] + [
            torch.mean(v).detach().to(loss) for v in terms.values()])
        if mesh is not None:
            values = psum(values, mesh, RAY_AXIS)
        return dict(zip(["loss", *terms], values))

    return train_step


class Trainer:
    """Minimal step-loop runner.

    :param model: the module whose parameters are trained.
    :param forward_fn: (batch, generator) -> output dict, or a dict
        ``{variant: forward_fn}`` of forwards sharing ``model``'s
        parameters (count-jitter: one variant drawn per step, weighted by
        ``variant_probs``, uniform by default).
    :param val_fn: optional (model, step) -> dict of scalar metrics.
    :param mesh: optional ``parallel.mesh.Mesh``: split each step's rays
        over its ray axis (the batches ``fit`` takes are the whole batch).
    """

    def __init__(self, model: nn.Module, forward_fn, cfg: TrainerConfig,
                 val_fn: Optional[Callable] = None,
                 log_fn: Optional[Callable] = None,
                 variant_probs: Optional[Dict[str, float]] = None,
                 mesh=None):
        self.cfg = cfg
        self.model = model
        self.val_fn = val_fn
        self.log_fn = log_fn or (lambda step, m: None)
        self.mesh = mesh
        self.is_chief = mesh is None or mesh.rank == 0
        if mesh is not None:
            replicate_tree(mesh, model)
        self.opt, self.schedule = make_optimizer(cfg, model.parameters())
        self.step = 0
        if isinstance(forward_fn, dict):
            self.train_steps = {k: make_train_step(fn, cfg, self.opt,
                                                   self.schedule, mesh)
                                for k, fn in forward_fn.items()}
            if variant_probs is not None and \
                    set(variant_probs) != set(forward_fn):
                raise ValueError(f"variant_probs {sorted(variant_probs)} "
                                 f"!= variants {sorted(forward_fn)}")
        else:
            self.train_steps = {None: make_train_step(forward_fn, cfg,
                                                      self.opt, self.schedule,
                                                      mesh)}
        self.variant_probs = variant_probs
        self.best_metric = -float("inf")
        self._ckpt_dir = Path(cfg.save_dir) / cfg.name

    # -- checkpointing: the reference model.pth layout -------------------

    def ckpt_path(self, tag: str = "latest") -> Path:
        return self._ckpt_dir / tag / "model.pth"

    def save(self, tag: str = "latest") -> Path:
        """Write the checkpoint ``tag`` (rank 0 alone with a mesh); returns
        its path."""
        path = self.ckpt_path(tag)
        if not self.is_chief:
            return path
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"step": self.step, "best_para": self.best_metric,
                    "network_state_dict": self.model.state_dict(),
                    "optimizer_state_dict": self.opt.state_dict()}, path)
        return path

    def restore(self, tag: str = "latest") -> None:
        path = self.ckpt_path(tag)
        ckpt = None
        if self.is_chief and path.exists():
            ckpt = torch.load(path, map_location="cpu", weights_only=False)
        if self.mesh is not None:
            ckpt = broadcast_object(ckpt, self.mesh)
        if ckpt is None:
            raise FileNotFoundError(f"no checkpoint at {path}")
        self.model.load_state_dict(ckpt["network_state_dict"])
        self.opt.load_state_dict(ckpt["optimizer_state_dict"])
        self.step = int(ckpt["step"])
        self.best_metric = float(ckpt["best_para"])

    # -- loop --------------------------------------------------------------

    def variant_sequence(self, num_steps: int) -> list:
        """The variants ``fit`` runs in its first ``num_steps`` steps."""
        if None in self.train_steps:
            return [None] * num_steps
        keys = sorted(self.train_steps)
        rng = np.random.default_rng(self.cfg.seed)
        probs = None
        if self.variant_probs is not None:
            w = np.asarray([self.variant_probs[k] for k in keys], float)
            probs = w / w.sum()
        return [keys[int(rng.choice(len(keys), p=probs))]
                for _ in range(num_steps)]

    def fit(self, data_iter: Iterable, num_steps: Optional[int] = None,
            key_metric: str = "psnr_nr") -> Dict[str, float]:
        num_steps = num_steps or self.cfg.total_step
        generator = torch.Generator().manual_seed(self.cfg.seed)
        variants = self.variant_sequence(num_steps)
        last_metrics: Dict[str, float] = {}
        self.model.train()
        for i, batch in enumerate(data_iter):
            if i >= num_steps:
                break
            metrics = self.train_steps[variants[i]](batch, generator,
                                                    self.step)
            self.step += 1
            step = self.step
            if step % self.cfg.log_interval == 0 or i == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                if self.is_chief:
                    self.log_fn(step, last_metrics)
            if self.val_fn and self.is_chief and \
                    step % self.cfg.val_interval == 0:
                vm = self.val_fn(self.model, step)
                self.log_fn(step, vm)
                if vm.get(key_metric, -float("inf")) > self.best_metric:
                    self.best_metric = vm[key_metric]
                    self.save("best")
            if step % self.cfg.save_interval == 0:
                self.save("latest")
        return last_metrics


def load_checkpoint_params(path) -> dict:
    """The network state dict of a ``model.pth`` checkpoint (the layout
    ``Trainer.save`` writes and the reference trainer writes), of a bare
    state dict saved with ``torch.save``, or of an orbax checkpoint
    directory of the JAX package: ``Trainer.save``'s full state
    (``state.params``), a params-only tree, or ``tools/train_ft.py``'s
    ft renderer (``ray_feats`` among its params)."""
    path = Path(path)
    if path.is_dir():
        tree = read_tree(path)
        params = tree["state"]["params"] if "state" in tree else tree
        inner = params.get("params", params)
        if "ray_feats" in inner:
            return from_jax.ft_renderer_state_dict(params)
        return from_jax.renderer_state_dict(params)
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "network_state_dict" in raw:
        raw = raw["network_state_dict"]
    return {k: v for k, v in raw.items() if hasattr(v, "shape")}
