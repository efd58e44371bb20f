"""New scenes prepared back to back by one client (a closed loop).

Per scene the program runs the frozen depth stack on the two references
(``DepthStack.forward``), then ``full_render.prepare_ref_data`` on its
depth, and the client waits for the result before it sends the next.  A
pool of ``pool`` distinct two-reference scenes is drawn in set-up and
cycled.  The outputs of ``sampled`` scene calls of the window, a uniform
sample drawn from the seed, are kept for the check.
"""

from __future__ import annotations

import time

import torch

from h100bench import scenes
from h100bench.drivers.common import (Phases, Reservoir, Spans, count_flops,
                                      mean_gap, relative_gap, seeds, worst)
from h100bench.drivers.gen2v import Program, Reference, scene_inputs

MAP = "merged_full"


class Driver:
    unit = "scene"

    def __init__(self, cell, seed: int, device, trace: bool):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.dev = int(seed), torch.device(device)
        self.spans = Spans(trace and self.dev.type == "cuda")
        self.flops_per_item = None
        self.latencies = []

    def setup(self) -> None:
        cfg, tr = self.cfg, self.traffic
        self.phases = Phases()
        s = seeds(self.seed, 4 + 2 * tr["pool"])
        self.weight_seeds = s[:3]
        self.program = Program(cfg, self.weight_seeds, self.dev)
        self.shapes = self.program.shapes
        self.phases.mark("build")
        self.pool = [scene_inputs(scenes.three_view(
            s[4 + 2 * i], s[5 + 2 * i], cfg["height"], cfg["width"],
            cfg["m3d_dist"], self.dev)) for i in range(tr["pool"])]
        self.sample = Reservoir(tr["sampled"], s[3])
        self.k = 0
        self.phases.mark("traffic")
        for i in range(tr["warm_scenes"]):
            self._scene(self.pool[i % len(self.pool)])
        self._sync()
        self.phases.mark("warm")

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _scene(self, x: dict) -> dict:
        p = self.program
        tok = self.spans.start("stack")
        d = p.depth(x)
        self.spans.stop(tok)
        tok = self.spans.start("prepare_ref")
        ref_data = p.prepare(x, d["mvs_depth"])
        self.spans.stop(tok)
        return {"mvs_depth": d["mvs_depth"], "mono_depth": d["mono_depth"],
                MAP: ref_data[MAP]}

    def run_unit(self) -> int:
        i = self.k
        t0 = time.perf_counter()
        out = self._scene(self.pool[i % len(self.pool)])
        self._sync()
        self.latencies.append(time.perf_counter() - t0)
        self.sample.offer((i, out))
        self.k += 1
        return 1

    def end_to_end(self, seconds: float, items: int) -> dict:
        from h100bench.window import ms_per_unit, percentile
        return {"scene_ms": ms_per_unit(seconds, items),
                "scene_ms_p95": percentile(self.latencies, 95) * 1000.0}

    def release(self) -> None:
        self.checked = {i: (self.pool[i % len(self.pool)],
                            {k: v.float().cpu() for k, v in out.items()})
                        for i, out in self.sample.kept.values()}
        del self.program, self.sample

    def reference(self, lower: str | None = None,
                  count: bool = False) -> dict:
        from h100bench.reference.precision import lower as lowered
        # the map is held in the configuration's compute dtype, and the
        # reference's encoders round to it where the configuration does
        ref = Reference(self.cfg, self.shapes, self.weight_seeds, self.dev,
                        self.cfg["renderer"]["compute_dtype"])
        out = {}
        with lowered(lower):
            for n, (i, (x, _)) in enumerate(sorted(self.checked.items())):
                if count and n == 0:
                    r, self.flops_per_item = count_flops(
                        lambda: ref.scene(x))
                else:
                    r = ref.scene(x)
                out[i] = {"mvs_depth": r["mvs_depth"].cpu(),
                          "mono_depth": r["mono_depth"].cpu(),
                          MAP: r["ref_data"][MAP].float().cpu()}
        return out

    def program_record(self) -> dict:
        return {i: out for i, (_, out) in self.checked.items()}

    def readings(self, prog: dict, ref: dict) -> dict:
        """The widest relative gap of each output over the sampled
        scenes, and the merged map's mean relative gap (``map_mean_gap``:
        a rounding of its bf16 elements that a float32 reordering flips
        moves the widest gap by a whole unit of the last place)."""
        res = {}
        for key, name, gap in (("mvs_depth", "mvs_depth_gap", relative_gap),
                               ("mono_depth", "mono_depth_gap",
                                relative_gap),
                               (MAP, "map_gap", relative_gap),
                               (MAP, "map_mean_gap", mean_gap)):
            res[name] = worst(gap(prog[i][key], ref[i][key])
                              for i in ref)
        return res
