"""Fused two-layer MLP: the hand-written CUDA kernel and its plain version.

Port of ``panogrf_tpu/ops/pallas/fused_mlp.py``'s ``mlp2`` /
``mlp2_batched``.  ``mlp2`` launches ``csrc/fused_mlp.cu`` for CUDA tensors
and takes the plain PyTorch version ``mlp2_plain`` only for CPU tensors;
a CUDA tensor the kernel does not take raises.  Serving needs no gradient;
the backward comes with the training slice.
"""

from __future__ import annotations

import torch

# Launches of the CUDA kernel in this process (a plain counter: callers
# reset it to 0 and read it back to see that a path went through it).
MLP2_LAUNCHES = 0

ACTS = {"none": 0, "elu": 1, "relu": 2, "sigmoid": 3, "softplus": 4}
MAX_DIN, MAX_HIDDEN, MAX_DOUT = 256, 64, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The JAX package's activation formulas (``fused_mlp.py:_act``)."""
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


def mlp2_plain(x, w1, b1, w2, b2, act1: str = "elu",
               act2: str = "elu") -> torch.Tensor:
    """Plain version, equal to the JAX package's ``_mlp2_ref`` (the hidden
    activation is rounded to x's dtype)."""
    return _act(_act(x @ w1 + b1, act1) @ w2 + b2, act2)


def _check(x, w1, b1, w2, b2, act1, act2):
    n, din = x.shape
    dh, dout = w1.shape[1], w2.shape[1]
    if act1 not in ACTS or act2 not in ACTS:
        raise ValueError(f"unknown activation {act1!r}/{act2!r}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"mlp2 kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if w1.shape != (din, dh) or b1.shape != (dh,) or w2.shape != (dh, dout) \
            or b2.shape != (dout,):
        raise ValueError("mlp2 weight shapes do not match x")
    if n == 0 or din > MAX_DIN or dh > MAX_HIDDEN or dout > MAX_DOUT:
        raise ValueError(f"mlp2 kernel supports 0 < N, Din <= {MAX_DIN}, "
                         f"H <= {MAX_HIDDEN}, Dout <= {MAX_DOUT}; got "
                         f"N={n}, {din}->{dh}->{dout}")
    for t in (x, w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError("mlp2 operands lie on different devices")
        if t.dtype != x.dtype:
            raise TypeError("mlp2 weights must have x's dtype")
        if not t.is_contiguous():
            raise ValueError("mlp2 kernel takes contiguous tensors only")


def mlp2(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
         w2: torch.Tensor, b2: torch.Tensor, act1: str = "elu",
         act2: str = "elu") -> torch.Tensor:
    """Fused ``act2(act1(x @ w1 + b1) @ w2 + b2)``.

    :param x: (N, Din); w1 (Din, H); b1 (H,); w2 (H, Dout); b2 (Dout,).
    :return: (N, Dout) in x's dtype.
    """
    if x.device.type == "cpu":
        return mlp2_plain(x, w1, b1, w2, b2, act1, act2)
    if x.device.type != "cuda":
        raise ValueError(f"mlp2 runs on CUDA or CPU tensors, got {x.device}")
    _check(x, w1, b1, w2, b2, act1, act2)
    from panogrf_tpu_torch.ops.kernels._build import load_library
    lib = load_library()
    n, din = x.shape
    dh, dout = w1.shape[1], w2.shape[1]
    out = torch.empty((n, dout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.panogrf_mlp2(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                          w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                          n, din, dh, dout, ACTS[act1], ACTS[act2],
                          _DTYPES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"mlp2 kernel launch failed (CUDA error {rc})")
    global MLP2_LAUNCHES
    MLP2_LAUNCHES += 1
    return out


def mlp2_batched(x: torch.Tensor, w1, b1, w2, b2, act1: str = "elu",
                 act2: str = "elu") -> torch.Tensor:
    """mlp2 over arbitrary leading dims: x (..., Din) -> (..., Dout)."""
    lead = x.shape[:-1]
    out = mlp2(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, act1, act2)
    return out.reshape(*lead, w2.shape[1])
