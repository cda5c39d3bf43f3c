"""Test settings of the benchmark's own tests (``python -m pytest portbench``)."""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips where there is none")


@pytest.fixture
def card():
    """The CUDA device, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")
