"""Tests of the benchmark: on the CPU at small sizes, and on the card
for those marked `chip`, which skip here with a reason.

Run them from the root of the checkout:

    python -m pytest benchmark/tests -q           # here, on the CPU
    python -m pytest benchmark/tests -q -m chip   # on a card
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA card; skips where there is none")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided here, at run
    time, never while the test module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: this host has none")
    return torch.device("cuda", 0)
