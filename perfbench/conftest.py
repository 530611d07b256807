"""Test settings of the benchmark's own tests (``perfbench/tests``).

Tests that need the card carry the ``card`` marker and take the ``card``
fixture, which skips them where no CUDA device is present; run them on the
chip with ``PYTHONPATH=src python3 -m pytest -q perfbench/tests -m card``.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the NVIDIA H100 (a CUDA device); skips without one")


@pytest.fixture
def card():
    """The CUDA device to test on; skips the test without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100): run on the chip")
    return "cuda"
