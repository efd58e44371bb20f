"""Shared helpers of the port's parity tests of multi-view training and
finetuning (``test_torch_port_mv.py``, ``test_torch_port_ft.py``).

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


def template_init(self, *args, **kw):
    """A flax module's ``init`` by shapes alone (``jax.eval_shape``), for
    callers that replace every leaf or read the weights from a file: an
    eager ``init`` of the big nets takes tens of seconds on the CPU."""
    return jax.eval_shape(lambda *a: fnn.Module.init(self, *a, **kw), *args)


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
