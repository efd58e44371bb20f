"""The MVS net's training step, in plain PyTorch.

Frozen from the port's ``train/depth_trainer.py`` and ``train/losses.py``
(the ``l1_sphere`` recipe of ``configs/depth/m3d_mvs.yaml``): the net in
training mode, the sin-weighted L1 of its depth plus ``aux_weight`` times
that of ``rectified_depth_d1``, every gradient element clipped to
``+-clip``, then one Adam step at a constant learning rate.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def l1_sphere_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """sin(phi)-weighted L1 of (B, H, W, 1) maps."""
    b, h, w, _ = pred.shape
    v = (torch.arange(h, dtype=torch.float32, device=pred.device) + 0.5) \
        * (math.pi / h)
    wmap = torch.sin(v)[None, :, None, None].expand(1, h, w, 1)
    return torch.sum(torch.abs(pred - gt) * wmap) / (torch.sum(wmap) * b
                                                     + 1e-7)


def step_loss(model: nn.Module, batch: dict, aux_weight: float
              ) -> torch.Tensor:
    out = model(batch["panos"], batch["rots"], batch["trans"],
                batch["mono_depth"], batch["mono_feat"])
    loss = l1_sphere_loss(out["depth"], batch["gt_depth"])
    if "rectified_depth_d1" in out:
        loss = loss + aux_weight * l1_sphere_loss(out["rectified_depth_d1"],
                                                  batch["gt_depth"])
    return loss


class TrainStep:
    """Adam over ``model``'s parameters with the recipe's settings."""

    def __init__(self, model: nn.Module, lr: float, betas: tuple,
                 eps: float, clip: float, aux_weight: float):
        self.model = model
        self.clip, self.aux_weight = clip, aux_weight
        self.opt = torch.optim.Adam(model.parameters(), lr=lr,
                                    betas=tuple(betas), eps=eps)

    def __call__(self, batch: dict) -> torch.Tensor:
        """One update; returns the loss.  Afterwards each parameter's
        ``.grad`` holds its clipped gradient."""
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss = step_loss(self.model, batch, self.aux_weight)
        loss.backward()
        nn.utils.clip_grad_value_(self.model.parameters(), self.clip)
        self.opt.step()
        return loss.detach()
