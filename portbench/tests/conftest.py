"""Tests of the benchmark itself, on the CPU at a tiny size (MobileNet-v1
0.25 @ 96, 4 lanes, a pool of 16 images), and on the card where one is
present (marked ``card``; they skip here).

    PYTHONPATH=src python -m pytest -q portbench/tests
"""
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
for p in (CHECKOUT / "src", CHECKOUT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
