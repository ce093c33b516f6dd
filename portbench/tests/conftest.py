"""The benchmark's own tests, on the CPU (tests that need a card carry
the ``cuda`` marker and skip without one):

    python -m pytest portbench/tests -q
    python -m pytest portbench/tests -m cuda -q      # on the card

They import neither JAX nor the JAX package."""

import pytest
import torch


@pytest.fixture
def cuda():
    """Skips the test without a CUDA device (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
