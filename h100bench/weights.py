"""Random weights drawn on the device from a seed, in a few large calls.

The rule is the port's seeded initialisation (``nn/blocks.
init_parameters_``): LeCun-normal weights of every parameter of two or more
dimensions (fan-in = the elements of one output slice), unit 1-D
``weight`` scales and zero biases.  All normal draws of a module come from
one ``torch.randn`` on the device, so the same seed gives the program and
the reference the same weights without the one reading the other's.
"""

from __future__ import annotations

import torch
from torch import nn


def spec(module: nn.Module) -> list:
    """(name, shape) of every parameter, in registration order."""
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


def draw(shapes: list, seed: int, device) -> dict:
    """The parameters of ``shapes`` [(name, shape), ...] from ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    big = [(n, s) for n, s in shapes if len(s) >= 2]
    total = sum(torch.Size(s).numel() for _, s in big)
    flat = torch.randn(total, generator=g, device=dev)
    out, at = {}, 0
    for n, s in big:
        k = torch.Size(s).numel()
        out[n] = flat[at:at + k].view(s) / float(torch.Size(s[1:]).numel()
                                                 ) ** 0.5
        at += k
    for n, s in shapes:
        if len(s) < 2:
            out[n] = (torch.ones if n.endswith("weight") else torch.zeros)(
                s, device=dev)
    return out


@torch.no_grad()
def load(module: nn.Module, params: dict) -> nn.Module:
    """Copy ``params`` into ``module``'s parameters; every parameter must
    be given, at its shape."""
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise KeyError(f"{type(module).__name__}: weights lack {missing[:3]}"
                       f" and have no parameter for {extra[:3]}")
    for n, p in own.items():
        p.copy_(params[n])
    return module
