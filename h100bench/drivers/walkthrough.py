"""Video frames along camera paths through one prepared scene.

Set-up prepares the scene as the render CLI does (depth stack, then
``prepare_ref_data``).  Each path holds ``path_poses`` poses interpolated
between the two references (the CLI's ``--pose-type inter``), their
positions moved by up to ``path_jitter`` along each axis, drawn from the
seed; a new path is drawn when one is used up.  One unit is one pass of
``render_video_device`` over ``frame_batch`` poses of a path at
``chunk``-ray chunks.  ``sampled`` frames of the window, a uniform sample
drawn from the seed, are kept for the check.
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench import scenes
from h100bench.drivers.common import Phases, Reservoir, Spans, seeds, worst
from h100bench.drivers.gen2v import Program, Reference, scene_inputs


class Driver:
    unit = "frame"

    def __init__(self, cell, seed: int, device, trace: bool):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.dev = int(seed), torch.device(device)
        self.spans = Spans(trace and self.dev.type == "cuda")
        self.mlp2_calls = None

    def setup(self) -> None:
        cfg, tr = self.cfg, self.traffic
        if tr["path_poses"] % tr["frame_batch"]:
            raise ValueError("path_poses must be a multiple of frame_batch")
        self.phases = Phases()
        s = seeds(self.seed, 7)
        self.weight_seeds = s[:3]
        self.program = Program(cfg, self.weight_seeds, self.dev)
        self.shapes = self.program.shapes
        self.phases.mark("build")
        self.x = scene_inputs(scenes.three_view(
            s[3], s[4], cfg["height"], cfg["width"], cfg["m3d_dist"],
            self.dev))
        self.rng = np.random.default_rng(s[5])
        self.sample = Reservoir(tr["sampled"], s[6])
        ref_ids = list(scenes.REF_IDS)
        self.ends = self.x["c2w"][ref_ids].cpu().numpy()
        d = self.program.depth(self.x)
        self.ref_data = self.program.prepare(self.x, d["mvs_depth"])
        self.phases.mark("scene")
        n = self.ref_data["w2c"].shape[0]
        self.qdr = torch.tensor([cfg["render_depth_range"]],
                                device=self.dev)
        self.rdr = self.qdr.expand(n, 2).contiguous()
        self.frames = 0
        self.path, self.at = None, 0
        for _ in range(tr["warm_passes"]):
            self._pass(self._next_poses())
        self.frames = 0
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self.phases.mark("warm")
        from panogrf_tpu_torch.ops.kernels import fused_mlp
        self.fused_mlp = fused_mlp
        fused_mlp.reset_launches()

    def counters(self) -> dict:
        """The port's ``mlp2`` launches by variant since set-up, and per
        frame."""
        c = dict(self.fused_mlp.VARIANT_LAUNCHES)
        return {"mlp2_launches": c, "frames": self.frames}

    def _next_poses(self) -> np.ndarray:
        tr = self.traffic
        if self.path is None or self.at >= len(self.path):
            a, b = self.ends.copy(), self.ends.copy()
            j = tr["path_jitter"]
            a[0][:, 3] += self.rng.uniform(-j, j, 3)
            b[1][:, 3] += self.rng.uniform(-j, j, 3)
            self.path = scenes.inter_path(a[0], b[1], tr["path_poses"])
            self.at = 0
        grp = self.path[self.at:self.at + tr["frame_batch"]]
        self.at += tr["frame_batch"]
        return grp

    def _pass(self, grp: np.ndarray) -> torch.Tensor:
        p, cfg, tr = self.program, self.cfg, self.traffic
        return p.full_render.render_video_device(
            p.renderer, self.ref_data, grp, self.qdr, self.rdr,
            chunk=tr["chunk"], coarse_lowres=cfg["coarse_lowres"],
            coarse_chunk=cfg["coarse_chunk"], device=self.dev)

    def run_unit(self) -> int:
        grp = self._next_poses()
        tok = self.spans.start("pass")
        rgb = self._pass(grp)
        self.spans.stop(tok)
        for j in range(rgb.shape[0]):
            self.sample.offer((self.frames + j, grp[j], rgb[j]))
        self.frames += rgb.shape[0]
        return rgb.shape[0]

    def end_to_end(self, seconds: float, items: int) -> dict:
        from h100bench.window import ms_per_unit
        return {"frame_ms": ms_per_unit(seconds, items)}

    def release(self) -> None:
        self.checked = {i: (pose, rgb.float().cpu())
                        for i, pose, rgb in self.sample.kept.values()}
        del self.program, self.sample, self.ref_data

    def program_record(self) -> dict:
        return {i: rgb for i, (_, rgb) in self.checked.items()}

    def reference(self, lower: str | None = None,
                  count: bool = False) -> dict:
        from h100bench.reference import mlp
        from h100bench.reference.precision import lower as lowered
        from h100bench.reference.renderer import full_render
        ref = Reference(self.cfg, self.shapes, self.weight_seeds, self.dev)
        keys = sorted(self.checked)
        if not keys:
            return {}
        poses = np.stack([self.checked[i][0] for i in keys])
        n = self.traffic["frame_batch"]
        groups = []
        with lowered(lower):
            scene = ref.scene(self.x)
            for g in range(0, len(keys), n):
                if count and g == 0:
                    mlp.CALLS = []
                groups.append(full_render.render_video_device(
                    ref.renderer, scene["ref_data"], poses[g:g + n],
                    self.qdr, self.rdr, chunk=self.traffic["chunk"],
                    coarse_lowres=self.cfg["coarse_lowres"],
                    coarse_chunk=self.cfg["coarse_chunk"], device=self.dev))
                if mlp.CALLS is not None:
                    self.mlp2_calls, mlp.CALLS = mlp.CALLS, None
        rgb = torch.cat(groups)
        return {i: rgb[j].cpu() for j, i in enumerate(keys)}

    def readings(self, prog: dict, ref: dict) -> dict:
        """Per sampled frame, the mean absolute gap of its pixels and the
        share of pixels whose widest channel gap passes ``pixel_tol``;
        the worst frame's of each."""
        if not ref:
            return {"frame_mae": float("inf"),
                    "frame_bad_px": float("inf")}
        tol = self.traffic["pixel_tol"]
        mae, bad = [], []
        for i, r in ref.items():
            d = (prog[i].double() - r.double()).abs()
            if not bool(torch.isfinite(prog[i]).all()):
                mae.append(float("inf"))
                bad.append(float("inf"))
                continue
            mae.append(float(d.mean()))
            bad.append(float((d.amax(-1) > tol).double().mean()))
        return {"frame_mae": worst(mae), "frame_bad_px": worst(bad)}
