"""The benchmark of ``panogrf_tpu_torch`` on NVIDIA H100 cards.

``python -m h100bench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once (README.md).
"""
