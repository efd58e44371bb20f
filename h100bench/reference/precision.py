"""The reference computed one precision lower: the correctness control.

``lower(kind)`` is a context in which every matrix product and
convolution of the reference (``F.linear``, ``F.conv*``, ``matmul``,
``@``, ``mm``, ``bmm``, ``einsum``) takes its floating operands rounded
to that precision and accumulates as before:

* ``"tf32"``: float32 operands rounded to TF32's 10 mantissa bits, to
  nearest, ties to even (what the tensor cores take with TF32 on);
* ``"fp8"``: operands scaled per tensor so that the largest magnitude
  is 448, cast to ``float8_e4m3fn`` and back (the usual fp8 recipe).

The rounding is emulated with the same arithmetic on the CPU and on
the card.  The backward pass sees the rounded operands (a
straight-through rounding), as the products it differentiates took them.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

_PRODUCTS = {F.linear, F.conv1d, F.conv2d, F.conv3d, F.conv_transpose1d,
             F.conv_transpose2d, F.conv_transpose3d, torch.matmul,
             torch.Tensor.matmul, torch.Tensor.__matmul__,
             torch.Tensor.__rmatmul__, torch.mm, torch.Tensor.mm, torch.bmm,
             torch.Tensor.bmm, torch.einsum, torch.baddbmm, torch.addmm}


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with 10 mantissa bits (ties to even)."""
    if x.dtype != torch.float32:
        return x
    i = x.detach().contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return x + (r.view(torch.float32) - x).detach()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled round trip through ``float8_e4m3fn``."""
    if not x.is_floating_point():
        return x
    xd = x.detach().float()
    scale = 448.0 / xd.abs().amax().clamp(min=1e-30)
    q = ((xd * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)
    return x + (q - x.detach())


ROUNDERS = {"tf32": round_tf32, "fp8": round_fp8}


class _Lower(TorchFunctionMode):
    def __init__(self, rnd):
        super().__init__()
        self.rnd = rnd

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(self.rnd(a) if isinstance(a, torch.Tensor) else a
                         for a in args)
            kwargs = {k: self.rnd(v) if isinstance(v, torch.Tensor) and
                      k in ("weight", "input", "other", "mat2") else v
                      for k, v in kwargs.items()}
        return func(*args, **kwargs)


@contextlib.contextmanager
def lower(kind: str | None):
    """Run the enclosed reference one precision lower (``None``: as is)."""
    if kind is None:
        yield
        return
    with _Lower(ROUNDERS[kind]):
        yield
