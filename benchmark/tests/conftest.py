"""The benchmark's own tests: the repository's root on the path, so that
``benchmark`` and the port import as packages; a fixture that skips a test
without a CUDA card (decided when the test runs, never at import)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with "
                    "python -m pytest benchmark/tests -m gpu")
    return torch.device("cuda")
