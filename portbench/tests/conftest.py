"""CPU tests of the benchmark (``python -m pytest portbench/tests -q``).

The repository root goes on ``sys.path`` so that ``portbench`` and the
port import as packages. Tests that need a card are marked ``gpu`` and
decide inside the test, through the ``card`` fixture, whether one is there.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
