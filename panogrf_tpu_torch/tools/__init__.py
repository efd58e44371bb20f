"""Command-line tools of the port (``panogrf_tpu``'s ``tools/``)."""
