"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/ -q``)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips on a machine without "
        "one (run them there with python -m pytest benchmark/ -m card)")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
