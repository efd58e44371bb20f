"""Closed-loop training steps of the MVS depth net on its frozen prior.

As ``tools/train_depth.py`` runs them: each step runs the frozen UniFuse
prior (eval mode, inference) on the batch's reference views, then
``DepthTrainer.train_step`` (forward, backward, element-wise clip, Adam).
A pool of ``pool`` distinct batches of ``batch`` three-view scenes is
drawn in set-up and cycled.  Set-up drives the trainer through its first
``checked_steps`` steps on distinct batches, which the reference follows
from the seeded weights, and ``warm_steps`` more; the window continues the
same trainer.  Once the window has closed, the trainer's state (weights,
BatchNorm buffers, Adam's moments and counts) is copied and the same
trainer takes ``checked_steps`` more steps on the next batches of the
pool; the reference follows those from the copy, since no reference can
follow the window's hundreds of float32 steps from the seed.
"""

from __future__ import annotations

import statistics

import torch

from h100bench import scenes, weights
from h100bench.drivers.common import (Phases, Spans, count_flops, seeds,
                                      worst)


def _batch(cfg: dict, sub: list, device) -> dict:
    h, w, order = cfg["height"], cfg["width"], cfg["view_order"]
    samples = [scenes.three_view(a, b, h, w, cfg["m3d_dist"], device)
               for a, b in zip(sub[::2], sub[1::2])]
    return {"panos": torch.stack([s["rgb_panos"][order] for s in samples]),
            "rots": torch.stack([s["rots"][order] for s in samples]),
            "trans": torch.stack([s["trans"][order] for s in samples]),
            "gt_depth": torch.stack([torch.clamp(
                s["depth_panos"][order[1]], 0, cfg["max_depth"])
                for s in samples])}


def _mvs_kwargs(cfg: dict) -> dict:
    return dict(min_depth=cfg["min_depth"], max_depth=cfg["max_depth"],
                num_hypotheses=cfg["num_hypotheses"],
                magnet_num_samples=cfg["magnet_num_samples"],
                fixed_sigma=cfg["fixed_sigma"], wrap=cfg["wrap"],
                cnn3d_base=cfg["cnn3d_base"])


def _norms(tensors: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def _snapshot(model, opt) -> dict:
    """A copy of a trainer's state: parameters, buffers and Adam's state,
    by parameter name."""
    def copy(v):
        return v.detach().clone() if torch.is_tensor(v) else v
    return {"params": {k: copy(p) for k, p in model.named_parameters()},
            "buffers": {k: copy(b) for k, b in model.named_buffers()},
            "adam": {k: {n: copy(v) for n, v in opt.state[p].items()}
                     for k, p in model.named_parameters()
                     if p in opt.state}}


@torch.no_grad()
def _restore(model, opt, snap: dict) -> None:
    """Put ``snap`` (of a net with the same names) into ``model`` and
    ``opt``."""
    for k, p in model.named_parameters():
        p.copy_(snap["params"][k])
    for k, b in model.named_buffers():
        b.copy_(snap["buffers"][k])
    for k, p in model.named_parameters():
        if k in snap["adam"]:
            opt.state[p] = {n: v.clone() if torch.is_tensor(v) else v
                            for n, v in snap["adam"][k].items()}


def _moment(opt, p) -> torch.Tensor:
    """Adam's first moment of ``p`` in float64 (zero before its first
    step)."""
    m = opt.state.get(p, {}).get("exp_avg")
    return (torch.zeros_like(p) if m is None else m).detach().double()


class Driver:
    unit = "step"

    def __init__(self, cell, seed: int, device, trace: bool):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.dev = int(seed), torch.device(device)
        self.spans = Spans(trace and self.dev.type == "cuda")
        self.flops_per_item = None

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        from panogrf_tpu_torch.core import cubemap
        from panogrf_tpu_torch.models.mvs import MVSDepthModel
        from panogrf_tpu_torch.models.unifuse import (UniFuse,
                                                      normalize_imagenet)
        from panogrf_tpu_torch.train.depth_trainer import (DepthTrainConfig,
                                                           DepthTrainer)
        cfg, tr = self.cfg, self.traffic
        self.phases = Phases()
        s = seeds(self.seed, 2 + 2 * cfg["batch"] * tr["pool"])
        self.weight_seeds = s[:2]
        self.pool = [_batch(cfg, s[2 + 2 * cfg["batch"] * i:
                                   2 + 2 * cfg["batch"] * (i + 1)], self.dev)
                     for i in range(tr["pool"])]
        self.phases.mark("traffic")
        with torch.device(self.dev):     # their own init runs there
            mono = UniFuse(max_depth=cfg["max_depth"])
            model = MVSDepthModel(**_mvs_kwargs(cfg))
        self.shapes = (weights.spec(mono), weights.spec(model))
        weights.load(mono, weights.draw(self.shapes[0], s[0], self.dev))
        weights.load(model, weights.draw(self.shapes[1], s[1], self.dev))
        mono.requires_grad_(False).eval()
        self.phases.mark("build")
        half = cfg["height"] // 2

        @torch.inference_mode()
        def prior(ref):
            equi = normalize_imagenet(ref)
            out = mono(equi, cubemap.equi_to_cube(equi, half))
            return out["pred_depth"], out["mono_feat"]

        def forward_fn(batch):
            out = model(batch["panos"], batch["rots"], batch["trans"],
                        batch["mono_depth"], batch["mono_feat"])
            out["pred_depth"] = out.pop("depth")
            return out

        self.prior = prior
        self.trainer = DepthTrainer(model, forward_fn, DepthTrainConfig(
            learning_rate=cfg["lr"], opt_beta1=cfg["betas"][0],
            opt_beta2=cfg["betas"][1], clip_grad_value=cfg["clip"],
            loss_type=cfg["loss"], aux_d1_weight=cfg["aux_d1_weight"]))
        self.k = 0
        self.program = {"first": self._drive(model)}
        for _ in range(tr["warm_steps"]):
            self.run_unit()
        self.phases.mark("first_steps")

    def _step(self) -> torch.Tensor:
        batch = dict(self.pool[self.k % len(self.pool)])
        self.k += 1
        tok = self.spans.start("mono_prior")
        depth, feat = self.prior(batch["panos"][:, 1])
        batch["mono_depth"], batch["mono_feat"] = depth.clone(), feat.clone()
        self.spans.stop(tok)
        return self.trainer.train_step(batch)

    def _drive(self, model) -> dict:
        """The next ``checked_steps`` steps, through the window's call:
        each loss, the first step's gradient as Adam got it (from its
        first moment before and after the step), each parameter's
        change."""
        opt = self.trainer.opt
        b1 = opt.param_groups[0]["betas"][0]
        named = dict(model.named_parameters())
        start = {k: p.detach().clone() for k, p in named.items()}
        m0 = {k: _moment(opt, p) for k, p in named.items()}
        losses, grad = [], None
        for i in range(self.traffic["checked_steps"]):
            losses.append(self._step())
            if i == 0:
                grad = _norms({k: (_moment(opt, p) - b1 * m0[k]) / (1 - b1)
                               for k, p in named.items()})
        change = _norms({k: p.detach() - start[k] for k, p in named.items()})
        return {"losses": [float(x) for x in losses], "grad": grad,
                "change": change}

    # -- the window -----------------------------------------------------

    def run_unit(self) -> int:
        self._step()
        return 1

    def end_to_end(self, seconds: float, items: int) -> dict:
        return {"step_ms": seconds * 1000.0 / items}

    def program_record(self) -> dict:
        return self.program

    def release(self) -> None:
        """Copy the trainer's state, take the checked steps after the
        window, then free the program."""
        n, pool = self.traffic["checked_steps"], self.pool
        model = self.trainer.model
        self.after_start = _snapshot(model, self.trainer.opt)
        self.checked = {"first": pool[:n],
                        "after": [pool[(self.k + i) % len(pool)]
                                  for i in range(n)]}
        self.program["after"] = self._drive(model)
        del self.trainer, self.prior, self.pool

    # -- the check ------------------------------------------------------

    def reference(self, lower: str | None = None,
                  count: bool = False) -> dict:
        from h100bench.reference.depth import mono_prior
        from h100bench.reference.models.mvs import MVSDepthModel
        from h100bench.reference.models.unifuse import UniFuse
        from h100bench.reference.precision import lower as lowered
        from h100bench.reference.train import TrainStep
        cfg = self.cfg
        with torch.device(self.dev):
            mono = UniFuse(max_depth=cfg["max_depth"])
            model = MVSDepthModel(**_mvs_kwargs(cfg))
        weights.load(mono, weights.draw(self.shapes[0], self.weight_seeds[0],
                                        self.dev))
        weights.load(model, weights.draw(self.shapes[1],
                                         self.weight_seeds[1], self.dev))
        mono.requires_grad_(False).eval()
        out = {}
        for part in ("first", "after"):
            step = TrainStep(model, cfg["lr"], cfg["betas"], cfg["eps"],
                             cfg["clip"], cfg["aux_d1_weight"])
            if part == "after":
                _restore(model, step.opt, self.after_start)
            start = {k: p.detach().clone()
                     for k, p in model.named_parameters()}
            losses, grad = [], None
            with lowered(lower):
                for i, b in enumerate(self.checked[part]):
                    def one():
                        d, f = mono_prior(mono, b["panos"][:, 1])
                        return step({**b, "mono_depth": d, "mono_feat": f})
                    if count and part == "first" and i == 0:
                        loss, self.flops_per_item = count_flops(one)
                    else:
                        loss = one()
                    losses.append(float(loss))
                    if i == 0:
                        grad = _norms({k: p.grad for k, p
                                       in model.named_parameters()})
            change = _norms({k: p.detach() - start[k]
                             for k, p in model.named_parameters()})
            out[part] = {"losses": losses, "grad": grad, "change": change}
            del step
        return out

    @staticmethod
    def readings(prog: dict, ref: dict) -> dict:
        """Of the first checked steps (from the seed) and, prefixed
        ``after_``, of those after the window (from the copied state):
        ``loss_gap``, the widest relative gap of a step's loss;
        ``grad_gap`` and ``change_gap``, the widest gap of a leaf's norm
        (the first step's gradient; the change over the checked steps)
        over the larger of that leaf's reference norm and the median
        leaf's.  Leaves whose reference gradient is under a thousandth of
        the median leaf's move by round-off alone and are left out of the
        change."""
        first = _gaps(prog["first"], ref["first"])
        after = _gaps(prog["after"], ref["after"])
        return {**first, **{f"after_{k}": v for k, v in after.items()}}


def _gaps(prog: dict, ref: dict) -> dict:
    loss = worst(abs(p - r) / max(abs(r), 1e-30)
                 for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss = float("inf")
    gmed = statistics.median(ref["grad"].values())
    grad = worst(abs(prog["grad"][k] - g) / max(g, gmed, 1e-30)
                 for k, g in ref["grad"].items())
    moved = [k for k, g in ref["grad"].items() if g >= 1e-3 * gmed]
    cmed = statistics.median(ref["change"][k] for k in moved)
    change = worst(abs(prog["change"][k] - ref["change"][k])
                   / max(ref["change"][k], cmed, 1e-30) for k in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
