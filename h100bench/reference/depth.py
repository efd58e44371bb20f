"""The frozen depth stack and the MVS net's prior, in plain PyTorch.

Frozen from the port's ``models/depth_stack.py`` (``run_mono``,
``DepthStack.forward``) and ``tools/train_depth.py`` (the training
recipe's mono prior) at the commit named in ``h100bench/README.md``; the
nets are the frozen copies beside this file.
"""

from __future__ import annotations

import torch

from h100bench.reference.core import cubemap
from h100bench.reference.models.mvs import MVSDepthModel
from h100bench.reference.models.unifuse import UniFuse, normalize_imagenet
from h100bench.reference.nn.blocks import resize_linear


def run_mono(mono: UniFuse, imgs: torch.Tensor, mono_hw: tuple) -> dict:
    """UniFuse at its own resolution on (B, H, W, 3) RGB in [0, 1]."""
    mh, mw = mono_hw
    equi = normalize_imagenet(resize_linear(imgs, (mh, mw), axes=(1, 2)))
    return mono(equi, cubemap.equi_to_cube(equi, mh // 2))


@torch.no_grad()
def stack_forward(mono: UniFuse, mvs: MVSDepthModel, ref_imgs, src_imgs,
                  ref_w2c, src_w2c, mono_hw: tuple, depth_hw: tuple) -> dict:
    """Depth of every reference view: ``mvs_depth`` (rfn, dh, dw, 1) and
    ``mono_depth`` (rfn, mh, mw, 1); both nets in eval mode."""
    dh, dw = depth_hw
    m = run_mono(mono, ref_imgs, mono_hw)
    panos = torch.stack([resize_linear(src_imgs, (dh, dw), axes=(1, 2)),
                         resize_linear(ref_imgs, (dh, dw), axes=(1, 2))], 1)
    rots = torch.stack([src_w2c[:, :, :3], ref_w2c[:, :, :3]], 1)
    trans = torch.stack([src_w2c[:, :, 3], ref_w2c[:, :, 3]], 1)
    out = mvs(panos, rots, trans, m["pred_depth"], m.get("mono_feat"))
    return {"mvs_depth": torch.clamp(out["depth"], min=0.0),
            "mono_depth": m["pred_depth"]}


@torch.no_grad()
def mono_prior(mono: UniFuse, ref: torch.Tensor) -> tuple:
    """The MVS training recipe's prior on (B, H, W, 3) reference views at
    their own size: (pred_depth, mono_feat)."""
    equi = normalize_imagenet(ref)
    out = mono(equi, cubemap.equi_to_cube(equi, ref.shape[1] // 2))
    return out["pred_depth"], out["mono_feat"]
