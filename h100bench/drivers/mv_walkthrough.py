"""Video frames along camera paths through one prepared multi-view scene.

The walkthrough (``walkthrough.py``) on a scene of the multi-view model:
``views`` panoramas ``m3d_dist`` apart along one axis
(``scenes_mv.multi_view``), the references ``refs`` and the held-out
view ``query``.  Set-up prepares the scene through the port's multi-source
depth stack (each reference swept against every other reference) and
``prepare_ref_data``.  Each path runs from the first reference to the
held-out view, its ends moved by up to ``path_jitter`` along each axis; a
unit is one pass of ``render_video_device`` over ``frame_batch`` poses,
every aggregation pooling over the references.

The reference rebuilds the scene from the frozen copies
(``reference/depth_mv.py``, then the frozen renderer's ``prepare_ref``)
and renders the sampled frames, so the frames' comparison covers the
multi-source stack too; its depth is also compared with the stack's
(``mvs_depth_gap``: the widest gap over the largest depth).
"""

from __future__ import annotations

import numpy as np
import torch

from h100bench import scenes_mv
from h100bench.drivers import walkthrough
from h100bench.drivers.common import (Phases, Reservoir, relative_gap,
                                      seeds)
from h100bench.drivers.gen2v import Program, Reference

DEPTH = "mvs_depth"


class MVReference(Reference):
    """The frozen copies with the seeded weights; the scene's depth from
    the frozen multi-source stack."""

    @torch.no_grad()
    def scene(self, x: dict) -> dict:
        from h100bench.reference.depth_mv import stack_forward_mv
        from h100bench.reference.nn.blocks import resize_linear
        cfg = self.cfg
        d = stack_forward_mv(self.mono, self.mvs, x["ref_imgs"],
                             x["src_imgs"], x["ref_w2c"], x["src_w2c"],
                             tuple(cfg["mono_hw"]), tuple(cfg["depth_hw"]))
        depth = resize_linear(d["mvs_depth"], tuple(cfg["depth_hw"]),
                              axes=(1, 2))
        ref_data = self.renderer.prepare_ref(x["ref_imgs"], depth)
        ref_data["w2c"] = x["ref_w2c"]
        return {**d, "ref_data": ref_data}


class Driver(walkthrough.Driver):

    def setup(self) -> None:
        from panogrf_tpu_torch.models import depth_stack
        if not hasattr(depth_stack, "other_refs"):
            raise RuntimeError("this port's depth stack sweeps one source a "
                               "reference: it cannot prepare a multi-view "
                               "scene")
        cfg, tr = self.cfg, self.traffic
        if tr["path_poses"] % tr["frame_batch"]:
            raise ValueError("path_poses must be a multiple of frame_batch")
        self.phases = Phases()
        s = seeds(self.seed, 7)
        self.weight_seeds = s[:3]
        self.program = Program(cfg, self.weight_seeds, self.dev)
        self.shapes = self.program.shapes
        self.phases.mark("build")
        self.x = scenes_mv.scene_inputs(scenes_mv.multi_view(
            s[3], s[4], cfg["height"], cfg["width"], cfg["m3d_dist"],
            cfg["views"], self.dev), cfg["refs"], cfg["query"])
        self.rng = np.random.default_rng(s[5])
        self.sample = Reservoir(tr["sampled"], s[6])
        c2w = self.x["c2w"].cpu().numpy()
        self.ends = np.stack([c2w[cfg["refs"][0]], c2w[cfg["query"]]])
        d = self.program.depth(self.x)
        self.stack_depth = d["mvs_depth"]
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

    def release(self) -> None:
        self.stack_depth = self.stack_depth.float().cpu()
        super().release()

    def program_record(self) -> dict:
        return {**super().program_record(), DEPTH: self.stack_depth}

    def reference(self, lower: str | None = None,
                  count: bool = False) -> dict:
        from h100bench.reference import mlp
        from h100bench.reference.precision import lower as lowered
        from h100bench.reference.renderer import full_render
        ref = MVReference(self.cfg, self.shapes, self.weight_seeds, self.dev)
        keys = sorted(self.checked)
        poses = np.stack([self.checked[i][0] for i in keys]) if keys else []
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
        out = {DEPTH: scene["mvs_depth"].float().cpu()}
        if groups:
            rgb = torch.cat(groups)
            out.update({i: rgb[j].cpu() for j, i in enumerate(keys)})
        return out

    def readings(self, prog: dict, ref: dict) -> dict:
        """The walkthrough's frame readings of the sampled frames, and
        ``mvs_depth_gap``, the stack's widest depth gap over the largest
        reference depth."""
        frames = {k: v for k, v in ref.items() if k != DEPTH}
        out = super().readings(prog, frames)
        out["mvs_depth_gap"] = (relative_gap(prog[DEPTH], ref[DEPTH])
                                if DEPTH in ref else float("inf"))
        return out
