"""Port of ``panogrf_tpu/data``."""
