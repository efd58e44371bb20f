"""Port of ``panogrf_tpu/renderer``."""
