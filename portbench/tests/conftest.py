"""pytest settings of the benchmark's tests: the `card` marker (a test
that needs an NVIDIA card; it decides inside the test, through the
`card` fixture, whether one is present, and skips with a reason here)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="session")
def _threads():
    import torch
    torch.set_num_threads(min(4, torch.get_num_threads()))
