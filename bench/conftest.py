"""pytest set-up of the benchmark's own tests (``python -m pytest bench``):
the harness on the import path, and the ``card`` marker of tests that need
an NVIDIA card, which skip without one (decided in the ``card`` fixture,
never while a module is imported)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
