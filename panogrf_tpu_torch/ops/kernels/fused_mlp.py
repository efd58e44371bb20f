"""Fused two- and three-layer MLPs: the hand-written CUDA kernels and their
plain versions.

Port of ``panogrf_tpu/ops/pallas/fused_mlp.py``'s ``mlp2`` /
``mlp2_batched`` and ``mlp3`` / ``mlp3_batched``.  For CUDA tensors
``mlp2`` and ``mlp3`` launch ``csrc/fused_mlp.cu`` through one
``autograd.Function``, ``_MlpFn``, whose backward differentiates the plain
version on the saved inputs, as the JAX package's custom VJPs do
(``fused_mlp.py:115-129,200-214``).  CPU tensors take the plain versions
``mlp2_plain`` / ``mlp3_plain``, which autograd differentiates natively; a
CUDA tensor the kernel does not take raises.

Each kernel has variants (``csrc/fused_mlp.cu``): ``generic`` (any width
within the limits, one thread per row) and specialised ones compiled for
the paths' widths: ``lanes`` (several lanes per row, CUDA cores),
``rows`` (one row per thread, CUDA cores) and ``mma`` (tensor cores).
``choose_variant`` picks one from the widths, the dtype and x's alignment
before the launch; a failing launch raises.
"""

from __future__ import annotations

import torch

# Launches of each CUDA kernel in this process (plain counters: callers
# reset them to 0 and read them back to see that a path went through them).
MLP2_LAUNCHES = 0
MLP3_LAUNCHES = 0
# the same launches by kernel and variant, e.g. VARIANT_LAUNCHES["mlp2_lanes"];
# and the aggregation net's cross-view pools by path: "pool_fused" for a
# launch of the cross_view_pool kernel ("pool_fused_v2" to "_v4" by its
# view count, "pool_points" the (ray, sample) points the launches took),
# "pool_plain" for a call that ran agg_net.pool_reference; and its ray
# attentions by path: "attn_fused" for a launch of the ray_attention kernel,
# "attn_plain" for a call that ran agg_net.MultiHeadAttention.forward
VARIANT_LAUNCHES = {"mlp2_lanes": 0, "mlp2_generic": 0, "mlp3_mma": 0,
                    "mlp3_rows": 0, "mlp3_generic": 0, "pool_fused": 0,
                    "pool_plain": 0, "pool_fused_v2": 0, "pool_fused_v3": 0,
                    "pool_fused_v4": 0, "pool_points": 0, "attn_fused": 0,
                    "attn_plain": 0}

ACTS = {"none": 0, "elu": 1, "relu": 2, "sigmoid": 3, "softplus": 4}
MAX_DIN, MAX_HIDDEN, MAX_DOUT = 256, 64, 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"generic": 0, "lanes": 1, "mma": 2, "rows": 3}
# (kernel, widths) -> {dtype: variant} of each specialised instantiation in
# csrc/fused_mlp.cu: the serving and training out_geometry_fc and the
# dist-decoder head shape
SPECIALISED = {
    ("mlp2", (16, 16, 1)): {torch.float32: "lanes", torch.bfloat16: "lanes"},
    ("mlp3", (32, 32, 32, 2)): {torch.float32: "rows", torch.bfloat16: "mma"},
}


def reset_launches() -> None:
    """Set every launch count (totals and per variant) to 0."""
    global MLP2_LAUNCHES, MLP3_LAUNCHES
    MLP2_LAUNCHES = MLP3_LAUNCHES = 0
    for k in VARIANT_LAUNCHES:
        VARIANT_LAUNCHES[k] = 0


def choose_variant(name: str, dims, dtype: torch.dtype, x_ptr: int) -> str:
    """The variant of kernel ``name`` for layer widths ``dims`` (Din, ...,
    Dout), ``dtype`` and x's address: the specialised one compiled for those
    widths and that dtype when x is 16-byte aligned (the specialised
    variants read rows with 16-byte loads; their row pitches are multiples
    of 16 bytes), else ``generic``."""
    picked = SPECIALISED.get((name, tuple(dims)), {}).get(dtype)
    if picked is None or x_ptr % 16 \
            or dims[0] * torch.finfo(dtype).bits // 8 % 16:
        return "generic"
    return picked


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


def _mlp_plain(x, layers, acts) -> torch.Tensor:
    """``act_i(x @ W_i + b_i)`` through ``layers`` [(W, b), ...] in turn;
    each layer's output stays in x's dtype."""
    for (w, b), a in zip(layers, acts):
        x = _act(x @ w + b, a)
    return x


def mlp2_plain(x, w1, b1, w2, b2, act1: str = "elu",
               act2: str = "elu") -> torch.Tensor:
    """Plain version, equal to the JAX package's ``_mlp2_ref`` (the hidden
    activation is rounded to x's dtype)."""
    return _mlp_plain(x, [(w1, b1), (w2, b2)], (act1, act2))


def mlp3_plain(x, w1, b1, w2, b2, w3, b3,
               acts=("elu", "elu", "none")) -> torch.Tensor:
    """Plain version, equal to the JAX package's ``_mlp3_ref``."""
    return _mlp_plain(x, [(w1, b1), (w2, b2), (w3, b3)], acts)


def _check(name: str, x, layers, acts) -> None:
    """Raise on what the kernel does not take: ``layers`` is
    [(W (in, out), b (out,)), ...], ``acts`` one activation per layer."""
    n, din = x.shape
    if any(a not in ACTS for a in acts):
        raise ValueError(f"unknown activation in {acts!r}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    dims = [din]
    for w, b in layers:
        if w.dim() != 2 or w.shape[0] != dims[-1] or b.shape != w.shape[1:]:
            raise ValueError(f"{name} weight shapes do not match x")
        dims.append(w.shape[1])
    if n == 0 or din > MAX_DIN or max(dims[1:-1]) > MAX_HIDDEN \
            or dims[-1] > MAX_DOUT:
        raise ValueError(f"{name} kernel supports 0 < N, Din <= {MAX_DIN}, "
                         f"hidden <= {MAX_HIDDEN}, Dout <= {MAX_DOUT}; got "
                         f"N={n}, {'->'.join(map(str, dims))}")
    for t in [x] + [t for wb in layers for t in wb]:
        if t.device != x.device:
            raise ValueError(f"{name} operands lie on different devices")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} weights must have x's dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel takes contiguous tensors only")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch(name: str, x, layers, acts, variant: str | None = None
            ) -> torch.Tensor:
    """One launch of the ``panogrf_<name>`` kernel on checked CUDA operands
    (``layers`` [(W, b), ...], ``acts`` one activation per layer), in
    ``variant`` (default: ``choose_variant``'s)."""
    from panogrf_tpu_torch.ops.kernels._build import load_library
    lib = load_library()
    n, din = x.shape
    widths = [w.shape[1] for w, _ in layers]
    if variant is None:
        variant = choose_variant(name, (din, *widths), x.dtype, x.data_ptr())
    out = torch.empty((n, widths[-1]), dtype=x.dtype, device=x.device)
    rc = getattr(lib, f"panogrf_{name}")(
        x.data_ptr(), *[t.data_ptr() for wb in layers for t in wb],
        out.data_ptr(), n, din, *widths, *[ACTS[a] for a in acts],
        _VARIANTS[variant], _DTYPES[x.dtype], _stream(x))
    if rc != 0:
        raise RuntimeError(f"{name} kernel ({variant}) launch failed "
                           f"(CUDA error {rc})")
    global MLP2_LAUNCHES, MLP3_LAUNCHES
    if name == "mlp2":
        MLP2_LAUNCHES += 1
    else:
        MLP3_LAUNCHES += 1
    VARIANT_LAUNCHES[f"{name}_{variant}"] += 1
    return out


class _MlpFn(torch.autograd.Function):
    """Forward: the ``name`` kernel.  Backward: autograd through
    ``_mlp_plain`` on the saved inputs (the JAX package's ``_bwd``)."""

    @staticmethod
    def forward(ctx, name, acts, x, *params):
        ctx.save_for_backward(x, *params)
        ctx.acts = acts
        return _launch(name, x, list(zip(params[::2], params[1::2])), acts)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            x, *params = [t.detach().requires_grad_(True)
                          for t in ctx.saved_tensors]
            out = _mlp_plain(x, list(zip(params[::2], params[1::2])),
                             ctx.acts)
            grads = torch.autograd.grad(out, [x, *params], g)
        return (None, None, *grads)


def _on_cuda(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise otherwise."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    return True


def mlp2(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
         w2: torch.Tensor, b2: torch.Tensor, act1: str = "elu",
         act2: str = "elu") -> torch.Tensor:
    """Fused ``act2(act1(x @ w1 + b1) @ w2 + b2)``.

    :param x: (N, Din); w1 (Din, H); b1 (H,); w2 (H, Dout); b2 (Dout,).
    :return: (N, Dout) in x's dtype.
    """
    if not _on_cuda("mlp2", x):
        return mlp2_plain(x, w1, b1, w2, b2, act1, act2)
    _check("mlp2", x, [(w1, b1), (w2, b2)], (act1, act2))
    return _MlpFn.apply("mlp2", (act1, act2), x, w1, b1, w2, b2)


def mlp3(x: torch.Tensor, w1, b1, w2, b2, w3, b3,
         acts=("elu", "elu", "none")) -> torch.Tensor:
    """Fused 3-layer MLP ``act3(act2(act1(x@w1+b1)@w2+b2)@w3+b3)``.

    :param x: (N, Din); w1 (Din, H1); w2 (H1, H2); w3 (H2, Dout).
    :return: (N, Dout) in x's dtype.
    """
    acts = tuple(acts)
    if not _on_cuda("mlp3", x):
        return mlp3_plain(x, w1, b1, w2, b2, w3, b3, acts)
    _check("mlp3", x, [(w1, b1), (w2, b2), (w3, b3)], acts)
    return _MlpFn.apply("mlp3", acts, x, w1, b1, w2, b2, w3, b3)


def mlp2_batched(x: torch.Tensor, w1, b1, w2, b2, act1: str = "elu",
                 act2: str = "elu") -> torch.Tensor:
    """mlp2 over arbitrary leading dims: x (..., Din) -> (..., Dout)."""
    lead = x.shape[:-1]
    out = mlp2(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, act1, act2)
    return out.reshape(*lead, w2.shape[1])


def mlp3_batched(x: torch.Tensor, w1, b1, w2, b2, w3, b3,
                 acts=("elu", "elu", "none")) -> torch.Tensor:
    """mlp3 over arbitrary leading dims: x (..., Din) -> (..., Dout)."""
    lead = x.shape[:-1]
    out = mlp3(x.reshape(-1, x.shape[-1]), w1, b1, w2, b2, w3, b3, acts)
    return out.reshape(*lead, w3.shape[1])
