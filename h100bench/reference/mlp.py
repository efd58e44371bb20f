"""The plain two-layer MLP that stands in for the port's ``mlp2`` kernel.

Same formulas as the port's ``ops/kernels/fused_mlp.mlp2_plain`` (the
JAX package's ``_mlp2_ref``): ``act2(act1(x @ w1 + b1) @ w2 + b2)``, each
layer's output in x's dtype.  ``CALLS`` records the rows of every call
while a caller holds it non-None, so that a count of the kernel's work
can be read off the reference.
"""

from __future__ import annotations

import torch

CALLS: list | None = None


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "elu":
        return torch.where(x > 0, x, torch.exp(torch.clamp(x, max=0.0)) - 1.0)
    if kind == "relu":
        return torch.relu(x)
    if kind == "sigmoid":
        return torch.sigmoid(x)
    if kind == "softplus":
        return torch.clamp(x, min=0.0) + torch.log(1.0 + torch.exp(-x.abs()))
    if kind == "none":
        return x
    raise ValueError(kind)


def mlp2_batched(x: torch.Tensor, w1, b1, w2, b2, act1: str = "elu",
                 act2: str = "elu") -> torch.Tensor:
    """x (..., Din) -> (..., Dout)."""
    if CALLS is not None:
        CALLS.append((x[..., 0].numel(), x.shape[-1], w1.shape[1],
                      w2.shape[1]))
    return _act(_act(x @ w1 + b1, act1) @ w2 + b2, act2)
