"""Settings of the benchmark's own tests (``python -m pytest perfbench/tests``
from the root of a checkout): the ``card`` marker, for tests that need an
NVIDIA card and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda")
