"""Depth-network training loop (mono UniFuse finetune and 360-degree MVS).

Port of ``panogrf_tpu/train/depth_trainer.py``: one step loop serves both
recipes.  Each step runs the net in training mode (BatchNorm on batch
statistics, its running statistics updated as in the JAX package), takes
the configured depth loss (sin-weighted L1, berHu or Gaussian NLL on
``pred`` = (mu, sigma)) plus ``aux_d1_weight`` times the sin-weighted L1
of ``rectified_depth_d1`` where the net returns it, clips every gradient
element to +-``clip_grad_value`` (optax's ``clip``, not a global norm) and
takes one Adam step at a constant lr with optax's defaults.

BatchNorm statistics live in the modules' buffers: a net without
BatchNorm, or one whose BatchNorms are in eval mode, keeps its prior
statistics, as the JAX trainer keeps its prior state when a forward
mutates nothing.

Checkpoints are ``{save_dir}/{name}/checkpoint_{step}.pth`` files holding
``{"step", "model_state_dict"}`` in the reference state-dict layout, the
newest ``checkpoint_count`` kept (the JAX trainer writes orbax
directories, which the port does not read).  ``frozen`` modules are saved
beside the trained net under their prefix: the MVS trainer stores its
frozen mono net as ``d_net.*``, as reference MVS checkpoints do, so
``models/depth_stack.load_depth_stack`` reads an MVS checkpoint alone.
``restore`` loads the newest checkpoint's weights into the trained net and
takes the step from the file name; like the JAX trainer it does not
restore the Adam moments.

With a ``mesh`` (``parallel/mesh.py``) every rank runs the trainer on the
same stream of batches: each step trains on the rank's share of the
batch, the loss and the gradients averaged over the ranks (the net's
BatchNorms take cross-rank statistics once given ``bn_axis`` and the mesh,
``nn/blocks.set_bn_axis``); the parameters start from rank 0's, and only
rank 0 logs and writes checkpoints and sheets; ``restore`` reads on rank
0 and broadcasts.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from panogrf_tpu_torch.models.depth_stack import (load_reference_state,
                                                  read_checkpoint)
from panogrf_tpu_torch.models.unifuse import IMAGENET_MEAN, IMAGENET_STD
from panogrf_tpu_torch.parallel.mesh import (DATA_AXIS, Mesh,
                                             broadcast_object,
                                             place_depth_batch, pmean,
                                             replicate_tree, sync_grads)
from panogrf_tpu_torch.train import losses as L
from panogrf_tpu_torch.train import metrics as M
from panogrf_tpu_torch.train.trainer import ADAM_EPS
from panogrf_tpu_torch.utils import visualize as V


@dataclasses.dataclass
class DepthTrainConfig:
    name: str = "depth_run"
    total_iter: int = 100000
    learning_rate: float = 1e-4
    opt_beta1: float = 0.9
    opt_beta2: float = 0.999
    clip_grad_value: Optional[float] = 1.0
    loss_type: str = "l1_sphere"       # l1_sphere | berhu | gaussian_nll
    aux_d1_weight: float = 0.5         # weight of rectified_depth_d1's L1
    checkpoint_interval: int = 10000
    checkpoint_count: int = 3
    save_dir: str = "data/depth_model"
    log_interval: int = 100
    vis_interval: int = 0      # >0: turbo depth/error sheets every N steps


def depth_loss_fn(loss_type: str, pred: torch.Tensor, gt: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  sigma: torch.Tensor | None = None) -> torch.Tensor:
    if loss_type == "l1_sphere":
        return L.l1_sphere_loss(pred, gt, mask)
    if loss_type == "berhu":
        return L.berhu_loss(pred, gt, mask)
    if loss_type == "gaussian_nll":
        assert sigma is not None
        return L.gaussian_nll_loss(pred, sigma, gt, mask)
    raise ValueError(loss_type)


def _pred(out: dict) -> torch.Tensor:
    return out["pred"][..., :1] if "pred" in out else out["pred_depth"]


def _step_of(path: Path) -> int:
    return int(path.stem.split("_")[1])


class DepthTrainer:
    """Step loop for the mono and MVS depth nets.

    :param model: the trained net.
    :param forward_fn: batch -> output dict with ``pred_depth``
        (B, H, W, 1), optional ``pred`` (mu, sigma) and optional
        ``rectified_depth_d1``; the trainer sets the net's mode first.
        ``batch["gt_depth"]`` (and optional ``gt_mask``) supervise.
    :param frozen: modules saved beside the net under their prefix.
    :param mesh: optional ``parallel.mesh.Mesh``: train data-parallel over
        its data axis (the batches ``fit`` takes are the whole batch).
    """

    def __init__(self, model: nn.Module, forward_fn: Callable,
                 cfg: DepthTrainConfig, log_fn: Optional[Callable] = None,
                 mesh: Optional[Mesh] = None,
                 frozen: Optional[Dict[str, nn.Module]] = None):
        self.cfg = cfg
        self.model = model
        self.forward_fn = forward_fn
        self.frozen = dict(frozen or {})
        self.log_fn = log_fn or (lambda s, m: None)
        self.opt = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate,
                                    betas=(cfg.opt_beta1, cfg.opt_beta2),
                                    eps=ADAM_EPS)
        self.step = 0
        self.root = Path(cfg.save_dir) / cfg.name
        self.mesh = mesh
        self.is_chief = mesh is None or mesh.rank == 0
        if mesh is not None:
            replicate_tree(mesh, model)

    def loss(self, out: dict, batch: dict) -> torch.Tensor:
        """The configured depth loss of a forward's outputs, plus the
        ``rectified_depth_d1`` term."""
        cfg = self.cfg
        gt, mask = batch["gt_depth"], batch.get("gt_mask")
        sigma = out["pred"][..., 1:] if "pred" in out else None
        loss = depth_loss_fn(cfg.loss_type, _pred(out), gt, mask, sigma)
        if "rectified_depth_d1" in out:
            loss = loss + cfg.aux_d1_weight * depth_loss_fn(
                "l1_sphere", out["rectified_depth_d1"], gt, mask)
        return loss

    def train_step(self, batch: dict) -> torch.Tensor:
        """One update on ``batch`` (with a mesh, the whole batch, of which
        this rank trains on its share); returns the loss.  Afterwards each
        parameter's ``.grad`` holds its clipped gradient."""
        mesh = self.mesh
        if mesh is not None:
            batch = place_depth_batch(mesh, batch)
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(self.forward_fn(batch), batch)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            sync_grads(self.model.parameters(), mesh, DATA_AXIS, mean=True)
            loss = pmean(loss, mesh, DATA_AXIS)
        self.update()
        return loss

    def update(self) -> None:
        """Clip the parameters' ``.grad`` element-wise, then one Adam
        step."""
        if self.cfg.clip_grad_value:
            nn.utils.clip_grad_value_(self.model.parameters(),
                                      self.cfg.clip_grad_value)
        self.opt.step()

    def fit(self, data_iter: Iterable, num_steps: Optional[int] = None
            ) -> dict:
        num_steps = num_steps or self.cfg.total_iter
        t0 = time.time()
        last = {}
        for i, batch in enumerate(data_iter):
            if i >= num_steps:
                break
            loss = self.train_step(batch)
            self.step += 1
            if self.step % self.cfg.log_interval == 0 or i == 0:
                last = {"loss": float(loss),
                        "sec": round(time.time() - t0, 1)}
                if self.is_chief:
                    self.log_fn(self.step, last)
            if self.cfg.vis_interval and self.is_chief and \
                    self.step % self.cfg.vis_interval == 0:
                self.dump_vis(batch)
            if self.step % self.cfg.checkpoint_interval == 0:
                self.save()
        return last

    @torch.no_grad()
    def _predict(self, batch: dict) -> torch.Tensor:
        self.model.eval()
        return _pred(self.forward_fn(batch))

    def dump_vis(self, batch: dict) -> Path:
        """Write a ``[rgb |] gt | pred | error`` turbo sheet of the first
        sample of ``batch`` under ``{save_dir}/{name}/vis/``."""
        pred = self._predict(batch)
        if "panos" in batch:          # MVS batch: the reference view
            rgb = batch["panos"][0, 1].cpu().numpy()
        else:                         # mono batch, ImageNet-normalised
            rgb = np.clip(batch["equi"][0].cpu().numpy()
                          * np.asarray(IMAGENET_STD)
                          + np.asarray(IMAGENET_MEAN), 0, 1)
        return V.dump_depth_val(self.root / "vis", self.step, 0, rgb,
                                batch["gt_depth"][0].cpu().numpy(),
                                pred[0].cpu().numpy())

    # -- rolling checkpoints ----------------------------------------------

    def state_dict(self) -> dict:
        """The net's state dict with every frozen module's under its
        prefix, on the CPU."""
        sd = {k: v.detach().cpu() for k, v in self.model.state_dict().items()}
        for prefix, module in self.frozen.items():
            sd.update({f"{prefix}.{k}": v.detach().cpu()
                       for k, v in module.state_dict().items()})
        return sd

    def save(self) -> Path:
        """Write the step's checkpoint (rank 0 alone with a mesh) and drop
        the oldest beyond ``checkpoint_count``; returns its path."""
        path = self.root / f"checkpoint_{self.step}.pth"
        if not self.is_chief:
            return path
        self.root.mkdir(parents=True, exist_ok=True)
        torch.save({"step": self.step, "model_state_dict": self.state_dict()},
                   path)
        for old in self.checkpoints()[:-self.cfg.checkpoint_count]:
            old.unlink()
        return path

    def checkpoints(self) -> list:
        """The run's checkpoint files, oldest first."""
        return sorted(self.root.glob("checkpoint_*.pth"), key=_step_of)

    def restore(self) -> bool:
        newest = None
        if self.is_chief:
            cks = self.checkpoints()
            if cks:
                newest = (_step_of(cks[-1]), read_checkpoint(cks[-1]))
        if self.mesh is not None:
            newest = broadcast_object(newest, self.mesh)
        if newest is None:
            return False
        self.step, state = newest
        load_reference_state(self.model, state)
        return True

    def evaluate(self, batches: Iterable, max_batches: int = 8) -> dict:
        """sin-weighted ERP depth metrics, averaged over the samples of
        ``max_batches`` batches."""
        agg: Dict[str, list] = {}
        for i, batch in enumerate(batches):
            if i >= max_batches:
                break
            pred = self._predict(batch)
            for b in range(pred.shape[0]):
                m = M.depth_metrics_erp(pred[b], batch["gt_depth"][b])
                for k, v in m.items():
                    agg.setdefault(k, []).append(float(v))
        return {k: sum(v) / len(v) for k, v in agg.items()}
