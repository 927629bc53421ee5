"""Tests of the benchmark harness. They run on the CPU at small sizes;
a test that needs the card takes the `cuda_device` fixture, which skips
with a reason where there is none (decided when the test runs, never
when this file is imported)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")
    return torch.device("cuda")
