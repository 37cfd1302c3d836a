"""pytest settings of the benchmark's own tests (`portbench/tests/`).

Tests that need a CUDA card carry the `card` marker and decide inside
the test whether one is present; on a machine without one they skip.
"""
import torch

torch.set_num_threads(4)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where none is visible")
