"""Port of ``panogrf_tpu/parallel``: multi-GPU rendering and training over
``torch.distributed``, one process per rank (``launch.run_ranks``)."""
