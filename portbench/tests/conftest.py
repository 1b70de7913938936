"""The benchmark's own tests (run on the CPU; those that need a card
decide so inside a fixture and skip without one):

    python -m pytest portbench/tests -q
"""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture
def card():
    """The first CUDA device; the test skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")
