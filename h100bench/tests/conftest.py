"""The benchmark's own tests (run as ``python -m pytest h100bench/tests``).

Tests marked ``card`` need an NVIDIA card and skip without one; each
decides inside the test, never while its module is imported.
"""

import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


def pytest_sessionstart(session):
    torch.set_num_threads(min(4, torch.get_num_threads()))
