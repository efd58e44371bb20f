"""panogrf_tpu_torch — the PyTorch and CUDA port of ``panogrf_tpu``.

The package mirrors ``panogrf_tpu``'s subpackages one to one (``core``,
``data``, ``ops``, ``nn``, ``renderer``, ``train``, ``utils``, plus the
repo's ``tools/`` as ``tools``); hand-written CUDA kernels live in
``csrc/`` and their Python wrappers in ``ops/kernels/``.  It runs the
serving render (``renderer.full_render``) and renderer training
(``tools.train_renderer``) and imports neither JAX nor the JAX package.
Public functions keep the JAX package's channel-last layouts.
"""

__version__ = "0.2.0"
