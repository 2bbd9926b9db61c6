"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``card`` marker, and the fixture that decides,
when a test runs, whether a CUDA device is there."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda:0")
