"""The benchmark's CPU tests: `python -m pytest portbench/tests` from the
checkout's root.  Tests that need a CUDA card carry the `card` marker
and take the `card` fixture, which decides inside the test whether a
card is present; run them on the card with
`python -m pytest portbench/tests -m card`."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
