"""Test settings of the benchmark's own tests (``perfbench/tests``).

``card`` marks a test that needs the CUDA card; it skips elsewhere, decided
inside the ``card`` fixture when the test runs, never at import."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the card")
    return torch.device("cuda:0")
