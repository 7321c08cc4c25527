"""The benchmark's own tests: `python -m pytest bench_h100/tests -q` on the
CPU; the tests marked `card` need an NVIDIA H100 and skip without one
(`python -m pytest bench_h100/tests -q -m card` on the card)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs the NVIDIA H100 (skips without a CUDA device)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the H100)")
    return torch.device("cuda")
