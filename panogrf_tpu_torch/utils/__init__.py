"""Port of ``panogrf_tpu/utils``."""
