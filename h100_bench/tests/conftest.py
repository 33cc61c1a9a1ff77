"""CPU tests of the benchmark (``python -m pytest h100_bench/tests``): the
harness at a tiny size, with the port on the CPU (its plain twins).
Tests that need the card carry the ``cuda`` marker and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA CUDA device (skips without one)")


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
