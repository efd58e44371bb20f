"""Faults planted in the program under the timed path, for the tests
that see ``correct`` come out false (and for the calibration that reads
what each fault does to the compared numbers).

``plant(name)`` is a context that patches the port while it is open:

* ``frozen_state``: the training step returns its state unchanged (no
  optimizer update);
* ``half_batch``: half of each batch is left out (a training step takes
  the mean over the rest; the depth stack computes the first reference
  and repeats it; a video pass renders the first half of its poses and
  repeats them);
* ``altered_answer``: an answer is altered where it is produced (the
  depth net's prediction scaled by 1.05; one depth value of a scene moved
  by 1; the frames' colours scaled by 0.9).
"""

from __future__ import annotations

import contextlib

import torch

KINDS = {"depth_train": ("frozen_state", "half_batch", "altered_answer"),
         "scene_prep": ("half_batch", "altered_answer"),
         "walkthrough": ("half_batch", "altered_answer")}


@contextlib.contextmanager
def _patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def _halve(t):
    return t[: max(1, t.shape[0] // 2)] if torch.is_tensor(t) else t


def plant(kind: str, name: str):
    """The context that plants fault ``name`` for traffic ``kind``."""
    if name not in KINDS[kind]:
        raise ValueError(f"{kind} has no fault {name!r}")
    if kind == "depth_train":
        from panogrf_tpu_torch.models.mvs import MVSDepthModel
        from panogrf_tpu_torch.train.depth_trainer import DepthTrainer
        if name == "frozen_state":
            return _patched(DepthTrainer, "update",
                            lambda orig: lambda self: None)
        if name == "half_batch":
            return _patched(DepthTrainer, "train_step",
                            lambda orig: lambda self, b: orig(
                                self, {k: _halve(v) for k, v in b.items()}))

        def scaled(orig):
            def forward(self, *a, **k):
                out = orig(self, *a, **k)
                out["depth"] = out["depth"] * 1.05
                return out
            return forward
        return _patched(MVSDepthModel, "forward", scaled)
    if kind == "scene_prep":
        from panogrf_tpu_torch.models.depth_stack import DepthStack

        def stack(orig):
            def forward(self, ref, src, rw, sw):
                if name == "half_batch":
                    out = orig(self, *(_halve(t) for t in (ref, src, rw,
                                                            sw)))
                    return {k: torch.cat([v, v])[:ref.shape[0]]
                            for k, v in out.items()}
                out = orig(self, ref, src, rw, sw)
                d = out["mvs_depth"].clone()
                d[0, 0, 0, 0] += 1.0
                return {**out, "mvs_depth": d}
            return forward
        return _patched(DepthStack, "forward", stack)
    from panogrf_tpu_torch.renderer import full_render

    def video(orig):
        def render(model, ref_data, c2ws, *a, **k):
            if name == "half_batch":
                h = max(1, len(c2ws) // 2)
                rgb = orig(model, ref_data, c2ws[:h], *a, **k)
                return torch.cat([rgb] * (len(c2ws) // h)
                                 + [rgb[:len(c2ws) % h]])
            return orig(model, ref_data, c2ws, *a, **k) * 0.9
        return render
    return _patched(full_render, "render_video_device", video)
