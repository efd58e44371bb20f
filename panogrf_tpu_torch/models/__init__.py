"""Port of ``panogrf_tpu/models``: the frozen depth stack."""
