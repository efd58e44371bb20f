"""Shared helpers of the port's parity tests of multi-view training,
finetuning and the stage profilers (``test_torch_port_mv.py``,
``test_torch_port_ft.py``, ``test_torch_port_profile.py``).

Tolerances are ``test_torch_port_train.py``'s: outputs and losses within
1e-4; each gradient within 1e-2 of its parameter's largest, plus 1e-6 of
the tree's largest for the parameters whose exact gradient is 0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch

from panogrf_tpu_torch.renderer import render_ops as tro

OUT_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_RTOL, GRAD_ATOL_REL = 1e-2, 1e-6


def to_torch(tree):
    """numpy/JAX leaves -> torch tensors (copies)."""
    return jax.tree.map(lambda a: torch.tensor(np.array(a)), tree)


def to_f64(tree):
    """float32 leaves -> float64 JAX arrays (for ``jax.enable_x64``)."""
    return jax.tree.map(lambda a: jnp.asarray(
        a, jnp.float64 if np.asarray(a).dtype == np.float32 else None), tree)


def f32_uniform(mp):
    """Under ``jax.enable_x64``: JAX's uniform draws come out in float32
    (then float64), so both packages sample at the same u."""
    draw = jax.random.uniform

    def uniform(key, shape=(), dtype=None, *args, **kw):
        return draw(key, shape, jnp.float32, *args, **kw).astype(jnp.float64)
    mp.setattr(jax.random, "uniform", uniform)


def inject_uniform(monkeypatch, draws):
    """``render_ops.uniform`` returns ``draws`` in order, each checked
    against the requested shape; returns the queue, empty once all are
    drawn."""
    queue = [np.asarray(d) for d in draws]

    def uniform(generator, shape, device=None):
        want = queue.pop(0)
        assert tuple(shape) == want.shape, (shape, want.shape)
        return torch.tensor(want).to(device)
    monkeypatch.setattr(tro, "uniform", uniform)
    return queue


def off_seam_coords(rng, n, h, w):
    """(1, n, 2) integer pixel coords off the border and the middle column.
    The procedural scenes put their cameras on one axis, so a ray there
    has points on another view's longitude seam, where the two packages'
    roundings may fetch pixels a column apart."""
    xs = rng.choice([x for x in range(1, w - 1) if abs(x - w // 2) > 1],
                    size=n)
    ys = rng.integers(1, h - 1, size=n)
    return np.stack([xs, ys], -1)[None].astype(np.float32)


def seeded_renderer_params(seed: int = 0, **kw) -> dict:
    """The JAX ``NeuralRayGenRenderer(**kw)``'s variables ({"params": ...}
    as numpy) from the port's renderer of the same flags, initialised
    from ``seed`` (LeCun-normal weights, unit norm scales and zero biases:
    the JAX initialisers' distributions, untruncated) and converted by
    ``convert_renderer``: a JAX ``init`` traces the whole renderer once
    more."""
    from panogrf_tpu.utils.torch_convert import convert_renderer
    from panogrf_tpu_torch.renderer.renderer import NeuralRayGenRenderer
    model = NeuralRayGenRenderer(
        **kw, device="cpu", generator=torch.Generator().manual_seed(seed))
    return jax.tree.map(np.asarray, convert_renderer(
        {k: v.numpy().copy() for k, v in model.state_dict().items()}))


def template_init(self, *args, **kw):
    """A flax module's ``init`` by shapes alone (``jax.eval_shape``), for
    callers that replace every leaf or read the weights from a file: an
    eager ``init`` of the big nets takes tens of seconds on the CPU."""
    return jax.eval_shape(lambda *a: fnn.Module.init(self, *a, **kw), *args)


def ill_conditioned(depth, hit, fine, near=0.5, far=15.0):
    """The hierarchical fine samples ``fine`` (qn, rn, fdn) whose depth
    moves by more than OUT_TOL when the sampler's CDF moves by the
    rounding error of a float32 cumulative sum of its dn terms (dn ulps of
    1).  In the sampler's inverse-depth coordinate x = (1/near - 1/d) /
    (1/near - 1/far), d depth / d cdf = d^2 (1/near - 1/far) (bin width)
    / (bin mass), from the coarse depths and hit-probs of float64 JAX."""
    span = 1 / near - 1 / far
    x = lambda d: (1 / near - 1 / d) / span
    xd = x(depth)
    bins = np.concatenate([xd[..., :1], (xd[..., 1:] + xd[..., :-1]) / 2,
                           xd[..., -1:]], -1)
    pdf = hit + 1e-5
    pdf = pdf / pdf.sum(-1, keepdims=True)
    j = (x(fine)[..., :, None] >= bins[..., None, 1:-1]).sum(-1)
    width = np.take_along_axis(np.diff(bins), j, -1)
    mass = np.take_along_axis(pdf, j, -1)
    moved = fine ** 2 * span * width / mass * depth.shape[-1] \
        * np.finfo(np.float32).eps
    return moved > OUT_TOL["atol"] + OUT_TOL["rtol"] * fine


def assert_grads_close(got: dict, want: dict) -> None:
    """Each gradient of ``got`` against ``want`` ({name: array}, the same
    keys) within GRAD_RTOL of the parameter's largest plus GRAD_ATOL_REL
    of the tree's largest."""
    assert got.keys() == want.keys()
    atol = GRAD_ATOL_REL * max(np.abs(v).max() for v in want.values())
    for k, a in want.items():
        np.testing.assert_allclose(
            got[k], a, rtol=0, atol=GRAD_RTOL * np.abs(a).max() + atol,
            err_msg=str(k))
