"""The benchmark's tests: ``pytest benchmark/tests``. Tests marked
``card`` need an NVIDIA card and skip without one (the ``card`` fixture
decides, inside the test)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return "cuda"
