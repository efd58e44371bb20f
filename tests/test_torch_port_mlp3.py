"""Port parity for the second kernel and both kernels' gradients:
``panogrf_tpu_torch.ops.kernels.fused_mlp``'s ``mlp3`` family against the
JAX package's ``mlp3`` (Pallas, run as its own tests run it on the CPU:
``interpret=True``) and ``_mlp3_ref``; the CUDA branch of ``mlp3``; and the
backward of ``_MlpFn`` for both kernels against ``jax.vjp`` of the JAX
functions.  The CUDA kernels cannot run here: the autograd Function is
driven on the CPU with its launcher replaced by the plain forward.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panogrf_tpu.ops.pallas import fused_mlp as jmlp
from panogrf_tpu_torch.ops.kernels import _build
from panogrf_tpu_torch.ops.kernels import fused_mlp as tmlp
from torch_port_threads import one_torch_thread  # noqa: F401

# float32: matmul and reduction order differ between XLA and PyTorch
F32_TOL = dict(atol=2e-5, rtol=2e-5)
# bfloat16: both round each layer's output and each elementwise step to
# 8 mantissa bits (2^-8 ~ 4e-3 per rounding), at different places
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
# gradients (float32): one more matmul per layer than the forward
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)


def _inputs(n, dims, seed):
    """x (n, dims[0]) and [(W, b), ...] for the layer widths ``dims``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(n, dims[0])).astype(np.float32)]
    for a, b in zip(dims[:-1], dims[1:]):
        arrs += [(rng.normal(size=(a, b)) * a ** -0.5).astype(np.float32),
                 (rng.normal(size=(b,)) * 0.1).astype(np.float32)]
    return arrs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("final", ["none", "softplus", "sigmoid", "elu",
                                   "relu"])
@pytest.mark.parametrize("n,dims", [(4099, (32, 32, 32, 2)),
                                    (1000, (35, 64, 48, 7))])
def test_mlp3_plain_matches_jax(dtype, final, n, dims):
    """Every final activation, a ragged row count at the dist-decoder head
    shape and a wide shape, against Pallas interpret and ``_mlp3_ref``."""
    arrs = _inputs(n, dims, seed=len(final) + dims[0])
    acts = ("elu", "elu", final)
    jx = [jnp.asarray(a, dtype) for a in arrs]
    j = np.asarray(jmlp.mlp3(*jx, acts, 1024, True), np.float32)
    ref = np.asarray(jmlp._mlp3_ref(jx[0], [(jx[1], jx[2]), (jx[3], jx[4]),
                                            (jx[5], jx[6])], acts),
                     np.float32)
    before = tmlp.MLP3_LAUNCHES
    t = tmlp.mlp3(*[torch.tensor(a).to(getattr(torch, dtype)) for a in arrs],
                  acts)
    assert tmlp.MLP3_LAUNCHES == before      # the CPU never counts a launch
    assert t.shape == (n, dims[-1]) and t.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(t.float().numpy(), j, **tol)
    np.testing.assert_allclose(t.float().numpy(), ref, **tol)


def test_mlp3_default_acts_and_batched_shapes():
    arrs = _inputs(3 * 5 * 7, (32, 32, 32, 1), seed=3)
    x = arrs[0].reshape(3, 5, 7, 32)
    j = jmlp.mlp3_batched(jnp.asarray(x), *map(jnp.asarray, arrs[1:]),
                          interpret=True)
    t = tmlp.mlp3_batched(torch.tensor(x), *map(torch.tensor, arrs[1:]))
    assert t.shape == (3, 5, 7, 1)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **F32_TOL)


class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to drive the wrapper's
    CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def _cuda_like(arrs):
    return [torch.Tensor._make_subclass(_LooksCuda, torch.tensor(a))
            for a in arrs]


def test_mlp3_cuda_tensor_never_takes_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper goes to the kernel (here: to the
    kernel's loader) or raises; the plain version is never reached."""
    class _Loaded(Exception):
        pass

    def fail(*a, **k):
        raise AssertionError("plain version used for a CUDA tensor")

    def loader():
        raise _Loaded

    monkeypatch.setattr(tmlp, "mlp3_plain", fail)
    monkeypatch.setattr(_build, "load_library", loader)
    with pytest.raises(_Loaded):
        tmlp.mlp3(*_cuda_like(_inputs(64, (32, 32, 32, 2), 0)))
    with pytest.raises(_Loaded):
        tmlp.mlp3_batched(*_cuda_like(_inputs(64, (32, 32, 32, 2), 0)))
    # widths beyond the kernel's limits raise before any launch
    for dims in [(300, 32, 32, 2), (32, 65, 32, 2), (32, 32, 65, 2),
                 (32, 32, 32, 65)]:
        with pytest.raises(ValueError):
            tmlp.mlp3(*_cuda_like(_inputs(8, dims, 0)))
    with pytest.raises(ValueError):
        tmlp.mlp3(*_cuda_like(_inputs(8, (32, 32, 32, 2), 0)),
                  ("elu", "elu", "tanh"))
    half = [torch.Tensor._make_subclass(_LooksCuda, torch.tensor(a).half())
            for a in _inputs(8, (32, 32, 32, 2), 0)]
    with pytest.raises(TypeError):
        tmlp.mlp3(*half)
    raw = _inputs(8, (32, 32, 32, 2), 0)
    arrs = _cuda_like(raw)
    arrs[3] = torch.Tensor._make_subclass(          # non-contiguous W2
        _LooksCuda, torch.tensor(raw[3]).t().contiguous().t())
    with pytest.raises(ValueError):
        tmlp.mlp3(*arrs)


@pytest.mark.parametrize("kernel", ["mlp2", "mlp3"])
@pytest.mark.parametrize("acts", [("elu", "relu", "none"),
                                  ("elu", "elu", "softplus"),
                                  ("relu", "sigmoid", "sigmoid")])
def test_kernel_autograd_function_backward_matches_jax(monkeypatch, kernel,
                                                       acts):
    """The backward of ``_MlpFn`` for each kernel (autograd through the
    plain version on the saved inputs) against ``jax.vjp`` of the JAX
    package's custom-VJP function, for x and every weight and bias."""
    dims = (16, 16, 1) if kernel == "mlp2" else (32, 32, 32, 2)
    acts = acts[:len(dims) - 1]
    arrs = _inputs(777, dims, seed=11)
    g = np.random.default_rng(12).normal(
        size=(777, dims[-1])).astype(np.float32)
    monkeypatch.setattr(tmlp, "_launch", lambda name, x, layers, acts:
                        tmlp._mlp_plain(x, layers, acts))
    if kernel == "mlp2":
        _, vjp = jax.vjp(lambda *a: jmlp.mlp2(*a, *acts, 1024, True),
                         *map(jnp.asarray, arrs))
    else:
        _, vjp = jax.vjp(lambda *a: jmlp.mlp3(*a, acts, 1024, True),
                         *map(jnp.asarray, arrs))
    want = [np.asarray(v) for v in vjp(jnp.asarray(g))]
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    out = tmlp._MlpFn.apply(kernel, acts, *ts)
    out.backward(torch.tensor(g))
    assert len(want) == len(ts)
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), w, **GRAD_TOL)
