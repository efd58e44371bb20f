"""Port parity for the kernel module and the ops below the renderer:
``panogrf_tpu_torch.ops.kernels.fused_mlp``, ``ops.resample``,
``core.sphere`` and the resize/padding primitives of ``nn.blocks``, each
against its JAX function on the same numpy inputs (CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panogrf_tpu.core import sphere as jsphere
from panogrf_tpu.nn import blocks as jblocks
from panogrf_tpu.ops import resample as jresample
from panogrf_tpu.ops.pallas import fused_mlp as jmlp
from panogrf_tpu_torch.core import sphere as tsphere
from panogrf_tpu_torch.nn import blocks as tblocks
from panogrf_tpu_torch.ops import resample as tresample
from panogrf_tpu_torch.ops.kernels import _build
from panogrf_tpu_torch.ops.kernels import fused_mlp as tmlp
from torch_port_threads import one_torch_thread  # noqa: F401

ACTS = ["elu", "relu", "sigmoid", "softplus", "none"]
# float32: matmul and reduction order differ between XLA and PyTorch
F32_TOL = dict(atol=2e-5, rtol=2e-5)
# bfloat16: both round the hidden layer and each elementwise step to 8
# mantissa bits (2^-8 ~ 4e-3 per rounding), at different places
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _mlp_inputs(n, din, dh, dout, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * sc for s, sc in
            [((n, din), 1.0), ((din, dh), din ** -0.5), ((dh,), 0.1),
             ((dh, dout), dh ** -0.5), ((dout,), 0.1)]]


def _mlp2_f64(arrs, act1, act2):
    """The JAX ``_act`` formulas evaluated in float64 numpy."""
    def act(v, kind):
        return {"elu": lambda: np.where(v > 0, v, np.exp(np.minimum(v, 0)) - 1),
                "relu": lambda: np.maximum(v, 0),
                "sigmoid": lambda: 1 / (1 + np.exp(-v)),
                "softplus": lambda: np.maximum(v, 0)
                + np.log1p(np.exp(-np.abs(v))),
                "none": lambda: v}[kind]()
    x, w1, b1, w2, b2 = (a.astype(np.float64) for a in arrs)
    return act(act(x @ w1 + b1, act1) @ w2 + b2, act2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act1", ACTS)
@pytest.mark.parametrize("act2", ["elu", "relu", "sigmoid"])
def test_mlp2_plain_matches_jax_wide(dtype, act1, act2):
    """Ragged N=5000 at a wide shape (35 -> 64 -> 32), every act1."""
    arrs = _mlp_inputs(5000, 35, 64, 32, seed=ACTS.index(act1))
    j = jmlp.mlp2(*[jnp.asarray(a, dtype) for a in arrs], act1, act2, 1024,
                  True)
    ref = jmlp._mlp2_ref(*[jnp.asarray(a, dtype) for a in arrs], act1, act2)
    before = tmlp.MLP2_LAUNCHES
    t = tmlp.mlp2(*[torch.tensor(a).to(getattr(torch, dtype)) for a in arrs],
                  act1, act2)
    assert tmlp.MLP2_LAUNCHES == before      # the CPU never counts a launch
    assert t.shape == (5000, 32) and t.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    out = t.float().numpy()
    if dtype == "float32":
        # the exact value first, so that a failure says which side strayed
        exact = _mlp2_f64(arrs, act1, act2)
        np.testing.assert_allclose(out, exact, **tol, err_msg="port")
        np.testing.assert_allclose(np.asarray(j), exact, **tol,
                                   err_msg="JAX")
    np.testing.assert_allclose(out, np.asarray(j, np.float32), **tol)
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act2", ACTS)
def test_mlp2_plain_matches_jax_path_shape(dtype, act2):
    """The serving path's shape: 16 -> 16 (ELU) -> 1 over 16 384 rows."""
    arrs = _mlp_inputs(16384, 16, 16, 1, seed=7)
    j = jmlp.mlp2(*[jnp.asarray(a, dtype) for a in arrs], "elu", act2, 1024,
                  True)
    t = tmlp.mlp2(*[torch.tensor(a).to(getattr(torch, dtype)) for a in arrs],
                  "elu", act2)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


def test_mlp2_batched_shapes():
    arrs = _mlp_inputs(3 * 7 * 11, 16, 16, 4, seed=3)
    x = arrs[0].reshape(3, 7, 11, 16)
    j = jmlp.mlp2_batched(jnp.asarray(x), *map(jnp.asarray, arrs[1:]),
                          "elu", "relu", interpret=True)
    t = tmlp.mlp2_batched(torch.tensor(x), *map(torch.tensor, arrs[1:]),
                          "elu", "relu")
    assert t.shape == (3, 7, 11, 4)
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


def test_mlp2_cuda_tensor_never_takes_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper goes to the kernel (here: to the
    kernel's loader) or raises; the plain version is never reached."""
    class _Loaded(Exception):
        pass

    def fail(*a, **k):
        raise AssertionError("plain version used for a CUDA tensor")

    def loader():
        raise _Loaded

    monkeypatch.setattr(tmlp, "mlp2_plain", fail)
    monkeypatch.setattr(_build, "load_library", loader)
    arrs = [torch.Tensor._make_subclass(_LooksCuda, torch.tensor(a))
            for a in _mlp_inputs(64, 16, 16, 1, seed=0)]
    with pytest.raises(_Loaded):
        tmlp.mlp2(*arrs, "elu", "relu")
    # unsupported widths, dtypes and layouts raise before any launch
    big = _mlp_inputs(64, 300, 16, 1, seed=0)
    with pytest.raises(ValueError):
        tmlp.mlp2(*[torch.Tensor._make_subclass(_LooksCuda, torch.tensor(a))
                    for a in big], "elu", "relu")
    half = [torch.Tensor._make_subclass(_LooksCuda, t.half())
            for t in map(torch.tensor, _mlp_inputs(64, 16, 16, 1, seed=0))]
    with pytest.raises(TypeError):
        tmlp.mlp2(*half, "elu", "relu")
    xt = torch.tensor(_mlp_inputs(16, 64, 16, 1, seed=0)[0]).t()
    rest = _mlp_inputs(64, 16, 16, 1, seed=0)[1:]
    with pytest.raises(ValueError):
        tmlp.mlp2(*[torch.Tensor._make_subclass(_LooksCuda, t) for t in
                    [xt] + list(map(torch.tensor, rest))], "elu", "relu")
    with pytest.raises(ValueError):
        tmlp.mlp2(*[t.to("meta") for t in map(torch.tensor, rest[:1] * 5)])


# ---------------------------------------------------------------------------
# sphere
# ---------------------------------------------------------------------------

def test_ray_directions_match_jax():
    a = np.asarray(jsphere.M3D.ray_directions(16, 32))
    b = tsphere.M3D.ray_directions(16, 32).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6)


def test_project_to_pixels_matches_jax_incl_seam_and_poles():
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    # points on the longitude seam (m3d: theta = -pi/2 <=> x = W-1 or 0),
    # straddling it, and at both poles
    seam = np.array([[0.0, 0.3, -1.0], [1e-7, 0.2, -1.0], [-1e-7, 0.2, -1.0],
                     [0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 0.0]],
                    np.float32)
    pts = np.concatenate([pts, seam])
    ja, jd = jsphere.M3D.project_to_pixels(jnp.asarray(pts), 32, 64)
    ta, td = tsphere.M3D.project_to_pixels(torch.tensor(pts), 32, 64)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=2e-5)


def test_get_convention():
    assert tsphere.get_convention("m3d") is tsphere.M3D
    with pytest.raises(KeyError):
        tsphere.get_convention("replica_test")


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------

def test_bilinear_sample_matches_jax_incl_seam():
    rng = np.random.default_rng(12)
    img = rng.normal(size=(16, 32, 5)).astype(np.float32)
    xy = np.stack([rng.uniform(-40, 72, 400), rng.uniform(-3, 19, 400)],
                  -1).astype(np.float32)
    # exactly on / next to the wrap seam, incl. an x whose wrap rounds
    # up to exactly W (the JAX gather clamps its window start there)
    edge = np.array([[31.0, 3.0], [31.5, 3.5], [32.0, 0.0], [-1e-7, 5.0],
                     [-32.0, 15.0], [0.0, 15.0], [-1e-6, 15.2]], np.float32)
    xy = np.concatenate([xy, edge])
    a = np.asarray(jresample.bilinear_sample(jnp.asarray(img),
                                             jnp.asarray(xy)))
    b = tresample.bilinear_sample(torch.tensor(img), torch.tensor(xy))
    np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-5)


def test_bilinear_sample_bf16_matches_jax():
    rng = np.random.default_rng(13)
    img = rng.normal(size=(8, 16, 4)).astype(np.float32)
    xy = np.stack([rng.uniform(-4, 20, 200), rng.uniform(-1, 9, 200)],
                  -1).astype(np.float32)
    a = jresample.bilinear_sample(jnp.asarray(img, jnp.bfloat16),
                                  jnp.asarray(xy))
    b = tresample.bilinear_sample(torch.tensor(img).bfloat16(),
                                  torch.tensor(xy))
    assert b.dtype == torch.bfloat16
    # same taps and weights; bf16 rounding of each product may differ
    np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                               **BF16_TOL)


def test_interpolate_feats_pointmajor_matches_jax():
    rng = np.random.default_rng(14)
    feats = rng.normal(size=(2, 8, 16, 6)).astype(np.float32)
    pts = np.stack([rng.uniform(0, 64, (2, 300)), rng.uniform(0, 31, (2, 300))],
                   -1).astype(np.float32)
    a = np.asarray(jresample.interpolate_feats_pointmajor(
        jnp.asarray(feats), jnp.asarray(pts), 32, 64))
    b = tresample.interpolate_feats_pointmajor(torch.tensor(feats),
                                               torch.tensor(pts), 32, 64)
    assert b.shape == (300, 2, 6)
    np.testing.assert_allclose(b.numpy(), a, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# resize / padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("out_hw", [(16, 32), (64, 128), (48, 20), (8, 1)])
def test_resize_linear_matches_jax(align, out_hw):
    rng = np.random.default_rng(15)
    x = rng.normal(size=(2, 32, 64, 3)).astype(np.float32)
    a = np.asarray(jblocks.resize_linear(jnp.asarray(x), out_hw, axes=(1, 2),
                                         align_corners=align))
    b = tblocks.resize_linear(torch.tensor(x), out_hw, axes=(1, 2),
                              align_corners=align)
    np.testing.assert_allclose(b.numpy(), a, atol=1e-6, rtol=1e-6)


def test_upsample_and_wrap_pad_match_jax():
    rng = np.random.default_rng(16)
    x = rng.normal(size=(2, 4, 8, 3)).astype(np.float32)
    a = np.asarray(jblocks.upsample2x_bilinear(jnp.asarray(x)))
    b = tblocks.upsample2x_bilinear(torch.tensor(x))
    np.testing.assert_allclose(b.numpy(), a, atol=1e-6)
    a = np.asarray(jblocks.wrap_pad_2d(jnp.asarray(x), 2, 3))
    b = tblocks.wrap_pad_2d(torch.tensor(x), 2, 3)
    np.testing.assert_array_equal(b.numpy(), a)
