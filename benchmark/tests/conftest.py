"""Settings of the benchmark's own tests (run them from the checkout's
root: `python -m pytest benchmark/tests -q`).  The tests marked `card` need
a CUDA device: they skip without one, decided inside the `card` fixture,
never while a module is imported."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")
