"""Frozen mono + MVS depth stack feeding the renderer's init net.

Port of ``panogrf_tpu/models/depth_stack.py``: for every reference view,
the frozen UniFuse mono net and the frozen MVS net run on the (source,
reference) panorama pair and predict the reference view's depth; no
ground-truth depth is read.  The stack runs in eval mode under
``torch.inference_mode``.

``load_depth_stack`` reads reference-layout checkpoints (``.pth``,
``.pt``, ``.tar``, ``.ckpt``) straight into the modules, with no
conversion step.  Orbax directories (the JAX depth trainer's output) are
not readable by the port.
"""

from __future__ import annotations

import pathlib

import torch
from torch import nn

from panogrf_tpu_torch.core import cubemap
from panogrf_tpu_torch.data.imgs_info import pose_w2c
from panogrf_tpu_torch.models.mvs import MVSDepthModel
from panogrf_tpu_torch.models.unifuse import UniFuse, normalize_imagenet
from panogrf_tpu_torch.nn.blocks import init_parameters_, resize_linear
from panogrf_tpu_torch.utils.device import resolve_device

CKPT_SUFFIXES = (".pt", ".pth", ".tar", ".ckpt")


def run_mono(mono_model: UniFuse, imgs: torch.Tensor,
             mono_hw: tuple) -> dict:
    """UniFuse at its own resolution on (B, H, W, 3) RGB in [0, 1]:
    ``pred_depth`` (B, mh, mw, 1), ``mono_feat``."""
    mh, mw = mono_hw
    equi = normalize_imagenet(resize_linear(imgs, (mh, mw), axes=(1, 2)))
    return mono_model(equi, cubemap.equi_to_cube(equi, mh // 2))


class DepthStack(nn.Module):
    """Frozen UniFuse + MVSDepthModel.

    ``wo_stereo`` (or no MVS net) is the reference's mono-only init path:
    the mono depth is resized to the MVS working resolution.
    """

    def __init__(self, mono_model: UniFuse,
                 mvs_model: MVSDepthModel | None,
                 mono_hw: tuple = (512, 1024), depth_hw: tuple = (256, 512),
                 wo_stereo: bool = False):
        super().__init__()
        self.mono_model = mono_model
        self.mvs_model = None if wo_stereo else mvs_model
        self.mono_hw, self.depth_hw = tuple(mono_hw), tuple(depth_hw)
        self.wo_stereo = wo_stereo or mvs_model is None
        self.requires_grad_(False)
        self.eval()

    @torch.inference_mode()
    def forward(self, ref_imgs: torch.Tensor, src_imgs: torch.Tensor,
                ref_w2c: torch.Tensor, src_w2c: torch.Tensor) -> dict:
        """Depth of every reference view.

        :param ref_imgs: (rfn, H, W, 3); src_imgs (rfn, H, W, 3), the
            source view paired with each reference.
        :param ref_w2c: (rfn, 3, 4) and src_w2c (rfn, 3, 4)
            world-to-camera poses.
        :return: ``mvs_depth`` (rfn, dh, dw, 1), and with the MVS net
            ``mono_depth`` (rfn, mh, mw, 1) and, when it predicts
            uncertainty, ``mvs_uncert``.
        """
        dh, dw = self.depth_hw
        mono = run_mono(self.mono_model, ref_imgs, self.mono_hw)
        if self.mvs_model is None:
            depth = resize_linear(mono["pred_depth"], (dh, dw), axes=(1, 2))
            return {"mvs_depth": torch.clamp(depth, min=0.0)}
        # (B, 2, ...) with index 0 = src, 1 = ref
        panos = torch.stack([resize_linear(src_imgs, (dh, dw), axes=(1, 2)),
                             resize_linear(ref_imgs, (dh, dw), axes=(1, 2))],
                            1)
        rots = torch.stack([src_w2c[:, :, :3], ref_w2c[:, :, :3]], 1)
        trans = torch.stack([src_w2c[:, :, 3], ref_w2c[:, :, 3]], 1)
        out = self.mvs_model(panos, rots, trans, mono["pred_depth"],
                             mono.get("mono_feat"))
        ret = {"mvs_depth": torch.clamp(out["depth"], min=0.0),
               "mono_depth": mono["pred_depth"]}
        if "pred_final" in out:
            ret["mvs_uncert"] = out["pred_final"][..., 1:]
        return ret


def init_depth_stack(seed: int = 0, mono_hw: tuple = (512, 1024),
                     depth_hw: tuple = (256, 512), wo_stereo: bool = False,
                     mvs_kwargs: dict | None = None,
                     device: str | torch.device = "cuda") -> DepthStack:
    """A DepthStack with random weights drawn from ``seed`` (LeCun-normal
    weights, unit norm scales, zero biases; BatchNorm statistics 0 and 1).
    Real runs load checkpoints (``load_depth_stack``)."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    mono = UniFuse()
    init_parameters_(mono, g)
    mvs = None
    if not wo_stereo:
        mvs = MVSDepthModel(**(mvs_kwargs or {}))
        init_parameters_(mvs, g)
    return DepthStack(mono, mvs, mono_hw, depth_hw, wo_stereo).to(dev)


def read_checkpoint(path) -> dict:
    """A reference-layout checkpoint file's state dict: unwrapped from
    ``model_state_dict``/``state_dict``/``model``, ``module.`` prefixes
    stripped."""
    p = pathlib.Path(path)
    if p.is_dir() or p.suffix not in CKPT_SUFFIXES:
        raise ValueError(
            f"{path}: not readable by the port (it reads reference-layout "
            f"{'/'.join(CKPT_SUFFIXES)} files; orbax checkpoint directories "
            "of the JAX depth trainer are not ported)")
    raw = torch.load(p, map_location="cpu", weights_only=False)
    for k in ("model_state_dict", "state_dict", "model"):
        if isinstance(raw, dict) and k in raw:
            raw = raw[k]
            break
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in raw.items() if hasattr(v, "shape")}


def load_reference_state(module: nn.Module, sd: dict) -> None:
    """Load the module's parameters and buffers from ``sd`` (keys it does
    not hold are ignored; a missing ``num_batches_tracked`` stays 0)."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} keys of "
                       f"{type(module).__name__}, e.g. {missing[:3]}")
    module.load_state_dict({k: sd.get(k, v) for k, v in own.items()},
                           strict=True)


def _dnet(sd: dict) -> dict:
    """The frozen mono net inside an MVS checkpoint (``d_net.*``)."""
    return {k[len("d_net."):]: v for k, v in sd.items()
            if k.startswith("d_net.")}


def load_depth_stack(mono_ckpt: str | None, mvs_ckpt: str | None = None,
                     mono_hw: tuple = (512, 1024),
                     depth_hw: tuple = (256, 512),
                     wo_stereo: bool = False, max_depth: float = 10.0,
                     mvs_kwargs: dict | None = None, seed: int = 0,
                     random_mvs: bool = False,
                     device: str | torch.device = "cuda") -> DepthStack:
    """A DepthStack from reference-layout checkpoints.

    The mono net comes from ``mono_ckpt`` (its ``d_net.*`` keys when it is
    an MVS checkpoint), else from ``mvs_ckpt``'s ``d_net.*`` keys, else
    random weights.  Without ``mvs_ckpt`` the MVS net is skipped, as in the
    JAX package, unless ``random_mvs`` asks for one with random weights;
    ``wo_stereo`` always skips it.
    """
    mvs_sd = read_checkpoint(mvs_ckpt) if mvs_ckpt else None
    stack = init_depth_stack(
        seed, mono_hw, depth_hw,
        wo_stereo=wo_stereo or (mvs_ckpt is None and not random_mvs),
        mvs_kwargs={"max_depth": max_depth, **(mvs_kwargs or {})},
        device=device)
    mono_sd = None
    if mono_ckpt:
        mono_sd = read_checkpoint(mono_ckpt)
        mono_sd = _dnet(mono_sd) or mono_sd
    elif mvs_sd is not None and _dnet(mvs_sd):
        mono_sd = _dnet(mvs_sd)
    if mono_sd is not None:
        load_reference_state(stack.mono_model, mono_sd)
    if mvs_sd is not None and stack.mvs_model is not None:
        load_reference_state(stack.mvs_model, mvs_sd)
    return stack


def stack_depth_for_sample(stack: DepthStack, sample: dict, ref_ids,
                           src_ids=None) -> dict:
    """Run the stack on a scene sample: each reference view is paired with
    a source view and the stack predicts its depth.

    :param sample: ``rgb_panos`` (V, H, W, 3), ``rots`` (V, 3, 3),
        ``trans`` (V, 3), on the stack's device.
    :param src_ids: the source view of each reference; by default the
        next reference, cyclically (refs (0, 2) -> srcs (2, 0)).
    """
    ref_ids = list(ref_ids)
    if src_ids is None:
        src_ids = [ref_ids[(i + 1) % len(ref_ids)]
                   for i in range(len(ref_ids))]
    src_ids = list(src_ids)
    w2c = pose_w2c(sample["rots"], sample["trans"])
    imgs = sample["rgb_panos"]
    return stack(imgs[ref_ids], imgs[src_ids], w2c[ref_ids], w2c[src_ids])
