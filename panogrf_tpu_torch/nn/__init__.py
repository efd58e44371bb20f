"""Port of ``panogrf_tpu/nn``."""
