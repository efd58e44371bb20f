"""Port of ``panogrf_tpu/core``."""
