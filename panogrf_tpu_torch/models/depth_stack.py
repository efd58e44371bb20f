"""Frozen mono + MVS depth stack feeding the renderer's init net.

Port of ``panogrf_tpu/models/depth_stack.py``: for every reference view,
the frozen UniFuse mono net and the frozen MVS net run on the (source,
reference) panorama pair, or on the reference and several sources (the
multi-view model: one sweep per source, the costs averaged), and predict
the reference view's depth; no ground-truth depth is read.  The stack
runs in eval mode under ``torch.inference_mode``.

``load_depth_stack`` reads reference-layout checkpoints (``.pth``,
``.pt``, ``.tar``, ``.ckpt``) straight into the modules, with no
conversion step: released reference checkpoints and the port's depth
trainers' ``checkpoint_{step}.pth`` files (an MVS checkpoint carries its
frozen mono net as ``d_net.*`` and loads alone).  It also reads the JAX
depth trainers' orbax checkpoint directories (``{"params",
"batch_stats"}``, through ``utils/orbax_read`` and ``utils/from_jax``;
such an MVS checkpoint holds no mono net).
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
from panogrf_tpu_torch.utils import from_jax
from panogrf_tpu_torch.utils.device import resolve_device
from panogrf_tpu_torch.utils.orbax_read import is_orbax_dir, read_tree
from panogrf_tpu_torch.utils.spans import span

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
            source view paired with each reference, or (rfn, S, H, W, 3),
            the S sources each reference is swept against (the MVS net
            averages their costs).
        :param ref_w2c: (rfn, 3, 4) and src_w2c (rfn, 3, 4), or
            (rfn, S, 3, 4) with S sources, world-to-camera poses.
        :return: ``mvs_depth`` (rfn, dh, dw, 1), and with the MVS net
            ``mono_depth`` (rfn, mh, mw, 1) and, when it predicts
            uncertainty, ``mvs_uncert``.
        """
        with span("stack"):
            dh, dw = self.depth_hw
            mono = run_mono(self.mono_model, ref_imgs, self.mono_hw)
            if self.mvs_model is None:
                depth = resize_linear(mono["pred_depth"], (dh, dw),
                                      axes=(1, 2))
                return {"mvs_depth": torch.clamp(depth, min=0.0)}
            if src_imgs.dim() == 4:
                # one source a reference: S = 1
                src_imgs, src_w2c = src_imgs[:, None], src_w2c[:, None]
            # (B, 1 + S, ...) in the MVS net's order [src_0, ref, src_1, ...]
            rfn, s = src_imgs.shape[:2]
            ref = resize_linear(ref_imgs, (dh, dw), axes=(1, 2))
            src = resize_linear(src_imgs.flatten(0, 1), (dh, dw),
                                axes=(1, 2)).unflatten(0, (rfn, s))
            panos = torch.cat([src[:, :1], ref[:, None], src[:, 1:]], 1)
            w2c = torch.cat([src_w2c[:, :1], ref_w2c[:, None],
                             src_w2c[:, 1:]], 1)
            rots = w2c[..., :3].contiguous()
            trans = w2c[..., 3].contiguous()
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
    """A depth net's state dict: from a reference-layout checkpoint file
    (unwrapped from ``model_state_dict``/``state_dict``/``model``,
    ``module.`` prefixes stripped), or from an orbax checkpoint directory
    of the JAX depth trainers, whose net is told from its tree."""
    p = pathlib.Path(path)
    if p.is_dir() and is_orbax_dir(p):
        return orbax_depth_state_dict(p)
    if p.is_dir() or p.suffix not in CKPT_SUFFIXES:
        raise ValueError(
            f"{path}: not readable by the port (it reads reference-layout "
            f"{'/'.join(CKPT_SUFFIXES)} files and orbax checkpoint "
            "directories)")
    raw = torch.load(p, map_location="cpu", weights_only=False)
    for k in ("model_state_dict", "state_dict", "model"):
        if isinstance(raw, dict) and k in raw:
            raw = raw[k]
            break
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in raw.items() if hasattr(v, "shape")}


def _depth_converter(p: dict):
    """The ``utils/from_jax`` converter of a JAX depth net's params, told
    from their top-level keys (None for a tree no converter takes)."""
    if "feature_net" in p and "decoders1" in p:
        return from_jax.mvs_state_dict
    if "enc0" in p.get("unet", {}):
        return from_jax.fnet_state_dict
    if "equi_encoder" in p and ("cube_encoder" in p or "tp_encoder" in p):
        return from_jax.unifuse_state_dict           # UniFuse, ERP+TP
    if "equi_encoder" in p:
        return from_jax.equi_depth_state_dict
    if "cube_encoder" in p:
        return from_jax.cube_depth_state_dict
    if "ResidualBlock_0" in p and "WrapConv_0" in p:
        return from_jax.uncert_head_state_dict
    return None


def orbax_depth_state_dict(path) -> dict:
    """The orbax directory ``path`` of a JAX depth trainer (``{"params",
    "batch_stats"}``: UniFuse, ERP+TP, Equi, Cube, the MVS net, FNET or
    the uncertainty head) -> the port's state dict of CPU tensors."""
    tree = read_tree(path)
    params = tree.get("params")
    convert = _depth_converter(params) if isinstance(params, dict) else None
    if convert is None:
        keys = sorted(params) if isinstance(params, dict) else None
        raise ValueError(f"{path}: not a depth net's orbax tree (top-level "
                         f"keys {sorted(tree)}, params keys {keys})")
    return convert({"params": params,
                    "batch_stats": tree.get("batch_stats", {})})


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


def extract_dnet(sd: dict) -> dict:
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
    ``wo_stereo`` always skips it.  An MVS checkpoint's head shapes set
    the net's ``num_hypotheses`` and ``mvs_uncertainty`` unless
    ``mvs_kwargs`` gives them.
    """
    mvs_sd = read_checkpoint(mvs_ckpt) if mvs_ckpt else None
    mvs_kwargs = {"max_depth": max_depth, **(mvs_kwargs or {})}
    if mvs_sd is not None:
        # the heads' shapes give the hypotheses and the (depth, sigma) head
        mvs_kwargs.setdefault("num_hypotheses",
                              mvs_sd["decoders1.conv.weight"].shape[1])
        mvs_kwargs.setdefault(
            "mvs_uncertainty",
            mvs_sd["decoders2.2.conv2.weight"].shape[0] == 2)
    stack = init_depth_stack(
        seed, mono_hw, depth_hw,
        wo_stereo=wo_stereo or (mvs_ckpt is None and not random_mvs),
        mvs_kwargs=mvs_kwargs, device=device)
    mono_sd = None
    if mono_ckpt:
        mono_sd = read_checkpoint(mono_ckpt)
        mono_sd = extract_dnet(mono_sd) or mono_sd
    elif mvs_sd is not None and extract_dnet(mvs_sd):
        mono_sd = extract_dnet(mvs_sd)
    if mono_sd is not None:
        load_reference_state(stack.mono_model, mono_sd)
    if mvs_sd is not None and stack.mvs_model is not None:
        load_reference_state(stack.mvs_model, mvs_sd)
    return stack


def other_refs(ref_ids) -> list:
    """Every other reference as the sources of each: refs [0, 1, 2] ->
    [[1, 2], [0, 2], [0, 1]] (the multi-view model's sweep against all
    neighbouring views)."""
    ref_ids = list(ref_ids)
    return [[r for r in ref_ids if r != ref] for ref in ref_ids]


def stack_depth_for_sample(stack: DepthStack, sample: dict, ref_ids,
                           src_ids=None) -> dict:
    """Run the stack on a scene sample: each reference view is swept
    against its source views and the stack predicts its depth.

    :param sample: ``rgb_panos`` (V, H, W, 3), ``rots`` (V, 3, 3),
        ``trans`` (V, 3), on the stack's device.
    :param src_ids: the source view of each reference, or a list of
        source views per reference (each list as long: e.g.
        ``other_refs(ref_ids)``); by default the next reference,
        cyclically (refs (0, 2) -> srcs (2, 0)).
    """
    ref_ids = list(ref_ids)
    if src_ids is None:
        src_ids = [ref_ids[(i + 1) % len(ref_ids)]
                   for i in range(len(ref_ids))]
    w2c = pose_w2c(sample["rots"], sample["trans"])
    imgs = sample["rgb_panos"]
    # a tensor index: a list of lists would index several dimensions
    src = torch.as_tensor(src_ids, device=imgs.device)
    return stack(imgs[ref_ids], imgs[src], w2c[ref_ids], w2c[src])
