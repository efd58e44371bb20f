"""Port of ``panogrf_tpu/train``."""
