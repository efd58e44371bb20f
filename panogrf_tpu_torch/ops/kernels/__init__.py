"""Hand-written CUDA kernels and their wrappers (port of ``panogrf_tpu/ops/pallas``)."""
