"""The benchmark's CPU tests: ``python -m pytest -q -p no:cacheprovider portbench/tests``."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

SMALL_GENOME = 20_000  # bases: a few thousand reads, tips and error kmers all present


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")
