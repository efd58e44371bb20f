"""Which modules a run may hold: none of JAX or of the JAX package.

Names are compared by their top-level part (before the first dot), whole:
``panogrf_tpu_torch`` is the program, ``panogrf_tpu`` the JAX package.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "panogrf_tpu")
# what the plain reference may not load besides
PROGRAM = "panogrf_tpu_torch"


def top_level(names) -> set:
    return {n.split(".", 1)[0] for n in names}


def foreign(names=None, forbidden=FORBIDDEN) -> list:
    """The forbidden top-level names among ``names`` (default: every module
    loaded in this process), sorted."""
    names = sys.modules if names is None else names
    return sorted(top_level(names) & set(forbidden))
