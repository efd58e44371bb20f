"""Port of ``panogrf_tpu/ops``."""
