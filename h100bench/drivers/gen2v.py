"""The composed serving pipeline of a two-reference scene, for the
drivers that prepare scenes and render frames.

The program: the port's frozen depth stack (UniFuse, then the MVS net) on
the two references and their sources (the 3-view protocol: references 0
and 2, each the other's source), then ``full_render.prepare_ref_data`` on
the stack's depth, as the render CLI runs them.  The reference: the same
chain built from the frozen copies under ``h100bench/reference``, from
the same inputs and the same seeded weights.
"""

from __future__ import annotations

import torch

from h100bench import scenes, weights


def scene_inputs(sample: dict) -> dict:
    w2c = scenes.pose_w2c(sample["rots"], sample["trans"])
    ref, src = list(scenes.REF_IDS), list(scenes.SRC_IDS)
    return {"ref_imgs": sample["rgb_panos"][ref],
            "src_imgs": sample["rgb_panos"][src],
            "ref_w2c": w2c[ref], "src_w2c": w2c[src],
            "c2w": scenes.c2w_from_w2c(w2c)}


def _renderer_kwargs(cfg: dict) -> dict:
    r = cfg["renderer"]
    return dict(height=cfg["height"], width=cfg["width"],
                depth_hw=tuple(cfg["depth_hw"]), **r)


def _build(mono_cls, mvs_cls, renderer_cls, renderer_kw: dict, cfg: dict,
           dev: torch.device) -> tuple:
    """The three nets built on ``dev`` itself: their own initialisation,
    which the seeded weights replace, runs there and not on the host."""
    with torch.device(dev):
        return (mono_cls(**cfg["mono"]), mvs_cls(**cfg["mvs"]),
                renderer_cls(**renderer_kw, device=dev,
                             generator=torch.Generator(device=dev)))


class Program:
    """The port's stack and renderer with the seeded weights."""

    def __init__(self, cfg: dict, weight_seeds: list, device):
        from panogrf_tpu_torch.models.depth_stack import DepthStack
        from panogrf_tpu_torch.models.mvs import MVSDepthModel
        from panogrf_tpu_torch.models.unifuse import UniFuse
        from panogrf_tpu_torch.nn.blocks import resize_linear
        from panogrf_tpu_torch.renderer import full_render
        from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
        self.cfg, self.dev = cfg, torch.device(device)
        mono, mvs, self.renderer = _build(UniFuse, MVSDepthModel,
                                          NeuralRayGenRenderer,
                                          _renderer_kwargs(cfg), cfg,
                                          self.dev)
        self.shapes = [weights.spec(m) for m in (mono, mvs, self.renderer)]
        for m, shp, s in zip((mono, mvs, self.renderer), self.shapes,
                             weight_seeds):
            weights.load(m, weights.draw(shp, s, self.dev))
        self.renderer.eval()
        self.stack = DepthStack(mono, mvs, tuple(cfg["mono_hw"]),
                                tuple(cfg["depth_hw"]))
        self.resize = resize_linear
        self.full_render = full_render

    def depth(self, x: dict) -> dict:
        """The stack on one scene: ``mvs_depth`` and ``mono_depth``."""
        return self.stack(x["ref_imgs"], x["src_imgs"], x["ref_w2c"],
                          x["src_w2c"])

    def prepare(self, x: dict, mvs_depth: torch.Tensor) -> dict:
        depth = self.resize(mvs_depth, tuple(self.cfg["depth_hw"]),
                            axes=(1, 2))
        return self.full_render.prepare_ref_data(
            self.renderer, {"imgs": x["ref_imgs"], "mvs_depth": depth,
                            "w2c": x["ref_w2c"]}, device=self.dev)


class Reference:
    """The frozen copies with the same seeded weights; the renderer
    computes in ``compute_dtype`` (float32 unless a check compares what
    the configuration holds in a lower one)."""

    def __init__(self, cfg: dict, shapes: list, weight_seeds: list, device,
                 compute_dtype: str = "float32"):
        from h100bench.reference.models.mvs import MVSDepthModel
        from h100bench.reference.models.unifuse import UniFuse
        from h100bench.reference.renderer.renderer import \
            NeuralRayGenRenderer
        self.cfg, self.dev = cfg, torch.device(device)
        kw = _renderer_kwargs(cfg)
        kw["compute_dtype"] = compute_dtype
        self.mono, self.mvs, self.renderer = _build(
            UniFuse, MVSDepthModel, NeuralRayGenRenderer, kw, cfg, self.dev)
        for m, shp, s in zip((self.mono, self.mvs, self.renderer), shapes,
                             weight_seeds):
            weights.load(m, weights.draw(shp, s, self.dev))
            m.requires_grad_(False).eval()

    @torch.no_grad()
    def scene(self, x: dict) -> dict:
        """``mvs_depth``, ``mono_depth`` and the prepared ``ref_data``."""
        from h100bench.reference.depth import stack_forward
        from h100bench.reference.nn.blocks import resize_linear
        cfg = self.cfg
        d = stack_forward(self.mono, self.mvs, x["ref_imgs"], x["src_imgs"],
                          x["ref_w2c"], x["src_w2c"], tuple(cfg["mono_hw"]),
                          tuple(cfg["depth_hw"]))
        depth = resize_linear(d["mvs_depth"], tuple(cfg["depth_hw"]),
                              axes=(1, 2))
        ref_data = self.renderer.prepare_ref(x["ref_imgs"], depth)
        ref_data["w2c"] = x["ref_w2c"]
        return {**d, "ref_data": ref_data}
