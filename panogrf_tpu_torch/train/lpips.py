"""LPIPS (VGG16 backbone) perceptual distance.

Port of ``panogrf_tpu/train/lpips.py``, the reference's
``lpips.LPIPS(net='vgg')`` on images scaled to [-1, 1]: the lpips
``ScalingLayer`` shift and scale, VGG16 convolution features tapped at
relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3, each tap normalised to unit
length over its channels, the squared difference weighted by the learned
1x1 "lin" head, averaged over space and summed over the taps.

The modules keep the released files' keys: ``VGG16Features`` holds
torchvision's ``features.N.*`` and ``LPIPS`` adds lpips'
``linK.model.1.weight``, so torchvision's ``vgg16`` state dict and lpips'
``weights/v0.1/vgg.pth`` load without conversion (``load_torch_state``).
``load_lpips_weights`` also reads the ``.npz`` that the JAX package's
``save_lpips_weights`` writes, and ``save_lpips_weights`` writes that
layout.  No weights ship with the repository; without them scoring
reports no LPIPS.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from panogrf_tpu_torch.nn.blocks import init_parameters_
from panogrf_tpu_torch.utils.device import resolve_device

# VGG16 convolution widths, "M" = 2x2 max pool; a tap is taken after the
# ReLU before each pool and after the last ReLU
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512]
TAP_CHANNELS = (64, 128, 256, 512, 512)

# lpips ScalingLayer constants (shift and scale of RGB in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _conv_indices() -> list:
    """The ``features.N`` index of each convolution (torchvision's
    Sequential: conv + ReLU take two slots, a pool one)."""
    out, i = [], 0
    for item in _VGG16:
        if item == "M":
            i += 1
        else:
            out.append(i)
            i += 2
    return out


class VGG16Features(nn.Module):
    """VGG16's convolution tower (torchvision's ``features`` up to
    relu5_3): NCHW images -> the five LPIPS taps."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in _VGG16:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, padding=1),
                           nn.ReLU(inplace=True)]
                cin = item
        self.features = nn.Sequential(*layers)

    def taps(self, x: torch.Tensor) -> list:
        out = []
        for layer in self.features:
            if isinstance(layer, nn.MaxPool2d):
                out.append(x)
            x = layer(x)
        return out + [x]

    def forward(self, x: torch.Tensor) -> list:
        return self.taps(x)


class _Lin(nn.Module):
    """lpips' ``NetLinLayer``: dropout, then a 1x1 convolution without
    bias (key ``model.1.weight``, shape (1, C, 1, 1))."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(),
                                   nn.Conv2d(channels, 1, 1, bias=False))


class LPIPS(VGG16Features):
    """(img0, img1) NHWC in [-1, 1] -> perceptual distance (N,)."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        for i, c in enumerate(TAP_CHANNELS):
            self.add_module(f"lin{i}", _Lin(c))
        # random convolutions (LeCun normal) and lin weights of 1, as the
        # JAX module initialises them; real scores load weights
        init_parameters_(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))
        with torch.no_grad():
            for i in range(len(TAP_CHANNELS)):
                self.lin_weight(i).fill_(1.0)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def lin_weight(self, i: int) -> torch.Tensor:
        return getattr(self, f"lin{i}").model[1].weight

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        def scaled(x):
            return (x.permute(0, 3, 1, 2) - self.shift) / self.scale
        total = 0.0
        for i, (a, b) in enumerate(zip(self.taps(scaled(img0)),
                                       self.taps(scaled(img1)))):
            a = a / torch.sqrt(torch.sum(a * a, 1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, 1, keepdim=True) + 1e-10)
            # lpips' lin weights are non-negative (trained so)
            d = F.conv2d((a - b) ** 2, self.lin_weight(i))
            total = total + torch.mean(d, (1, 2, 3))
        return total


def load_torch_state(model: LPIPS, vgg_state: dict, lin_state: dict) -> LPIPS:
    """Load torchvision's ``vgg16`` state dict (``features.N.*``; or an
    lpips full-model dict's ``net.sliceK.N.*``) and lpips' lin weights
    (``linK.model.1.weight``) into ``model``; returns it."""
    sd = {}
    for k, v in vgg_state.items():
        if k.startswith("features."):
            sd[k] = v
        elif ".slice" in k:      # the slices share torchvision's indices
            idx, name = k.split(".")[-2:]
            sd[f"features.{idx}.{name}"] = v
    sd.update({k: v for k, v in lin_state.items() if k.startswith("lin")})
    model.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    return model


def load_lpips_weights(path: str | Path,
                       device: str | torch.device = "cuda") -> LPIPS:
    """An ``LPIPS`` in eval mode on ``device`` with the weights of ``path``:
    an ``.npz`` in the JAX package's layout (``vgg/conv{i}/kernel`` HWIO,
    ``vgg/conv{i}/bias``, ``lin{i}`` (C,)), or a directory holding
    torchvision's ``vgg16.pth`` and lpips' ``lpips_vgg.pth``."""
    dev = resolve_device(device)
    path = Path(path)
    model = LPIPS()
    if path.suffix == ".npz":
        with np.load(path) as flat:
            sd = {}
            for i, idx in enumerate(_conv_indices()):
                sd[f"features.{idx}.weight"] = flat[
                    f"vgg/conv{i}/kernel"].transpose(3, 2, 0, 1)
                sd[f"features.{idx}.bias"] = flat[f"vgg/conv{i}/bias"]
            for i in range(len(TAP_CHANNELS)):
                sd[f"lin{i}.model.1.weight"] = flat[f"lin{i}"].reshape(
                    1, -1, 1, 1)
        model.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v))
                               for k, v in sd.items()})
    elif path.is_dir():
        load_torch_state(
            model, torch.load(path / "vgg16.pth", map_location="cpu",
                              weights_only=True),
            torch.load(path / "lpips_vgg.pth", map_location="cpu",
                       weights_only=True))
    else:
        raise ValueError(f"expected an .npz file or a directory with "
                         f"vgg16.pth and lpips_vgg.pth: {path}")
    return model.to(dev).eval()


def save_lpips_weights(model: LPIPS, path: str | Path) -> None:
    """Write ``model``'s weights as the JAX package's ``.npz``."""
    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    flat = {}
    for i, idx in enumerate(_conv_indices()):
        flat[f"vgg/conv{i}/kernel"] = sd[f"features.{idx}.weight"] \
            .transpose(2, 3, 1, 0)
        flat[f"vgg/conv{i}/bias"] = sd[f"features.{idx}.bias"]
    for i in range(len(TAP_CHANNELS)):
        flat[f"lin{i}"] = sd[f"lin{i}.model.1.weight"].reshape(-1)
    np.savez(path, **flat)


def lpips_fn(model: LPIPS) -> Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor]:
    """Scorer (gt, pred) NHWC in [0, 1] -> distances (N,), the inputs
    scaled to [-1, 1] as the reference calls lpips."""
    model.eval()

    @torch.inference_mode()
    def score(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        return model(gt * 2.0 - 1.0, pred * 2.0 - 1.0)

    return score
