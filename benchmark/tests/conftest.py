"""Tests of the benchmark harness. On the CPU they run at tiny sizes; the
tests marked `cuda` need a card and skip without one (decided in the
`card` fixture, never while a module is imported).

    python -m pytest benchmark/tests -q               # here, on the CPU
    python -m pytest benchmark/tests -q -m cuda       # on the card
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
