"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the checkout's root."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@pytest.fixture
def card():
    """The CUDA device a ``card`` test runs on; the test skips without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
