"""Data-parallel training steps over a mesh of ranks.

Port of ``panogrf_tpu/parallel/sharded_train.py``, under its names.
Parameters are replicated (``replicate_tree``: rank 0's values
broadcast); each step differentiates this rank's share of the batch and
all-reduces the gradients, so every rank takes the same update.  The
steps themselves are the trainers' own, given the mesh:

* Depth nets (``make_sharded_depth_step``, ``train/depth_trainer.
  DepthTrainer``): the batch's leading dimension is split over the mesh's
  data axis (``place_depth_batch``); the nets' BatchNorms, given
  ``bn_axis`` and the mesh (``nn/blocks.set_bn_axis``), take cross-rank
  statistics; each rank's loss is that of its samples, and the loss and
  the gradients are averaged over the ranks (``pmean``), as the JAX step
  under ``shard_map`` does.
* The renderer (``make_sharded_train_step``, ``train/trainer.
  make_train_step``): each step's query rays (the ``coords`` leaves) are
  split over the ray axis (``place_batch``) and everything else is
  replicated.  The step equals the single-device step up to rounding, as
  GSPMD's does in the JAX package: the renderer's random draws and its
  losses' means over rays take every rank's rays, so each rank's loss is
  its share of the whole batch's, and the gradients, the reference
  encoders' included, are summed over the ranks.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from panogrf_tpu_torch.parallel.mesh import Mesh, shard_ray_batch
# the JAX package's names, here for its callers
from panogrf_tpu_torch.parallel.mesh import (  # noqa: F401
    place_depth_batch, replicate_tree)
from panogrf_tpu_torch.train.depth_trainer import (DepthTrainConfig,
                                                   DepthTrainer)
from panogrf_tpu_torch.train.trainer import TrainerConfig, make_train_step

# the JAX package's name for the renderer batch's placement
place_batch = shard_ray_batch


def make_sharded_train_step(forward_fn: Callable, cfg: TrainerConfig,
                            opt: torch.optim.Optimizer, schedule: Callable,
                            mesh: Mesh) -> Callable:
    """The renderer's ``step(batch, generator, count) -> metrics``
    (``train/trainer.make_train_step``) with the rays split over
    ``mesh``'s ray axis: each rank takes the whole ``batch`` and renders
    its share; the returned loss and terms are the whole batch's, and
    after it each parameter's ``.grad`` holds the whole batch's (clipped)
    gradient."""
    return make_train_step(forward_fn, cfg, opt, schedule, mesh)


def make_sharded_depth_step(forward_fn: Callable, model: nn.Module,
                            mesh: Mesh,
                            cfg: DepthTrainConfig | None = None
                            ) -> Callable:
    """Data-parallel depth-net ``step(batch) -> loss`` over ``mesh``'s data
    axis (``DepthTrainer(mesh=mesh).train_step``; its Adam built from
    ``cfg``, default ``DepthTrainConfig()``): each rank takes the whole
    ``batch`` and trains on its share, the loss and the gradients averaged
    over the ranks, the gradients clipped element-wise to
    ``cfg.clip_grad_value`` and one Adam step taken.  Cross-rank BatchNorm needs ``set_bn_axis(model, DATA_AXIS,
    mesh)`` first; the running statistics come out the same on every
    rank.

    :param forward_fn: batch -> output dict, as ``DepthTrainer`` takes it.
    """
    return DepthTrainer(model, forward_fn, cfg or DepthTrainConfig(),
                        mesh=mesh).train_step
