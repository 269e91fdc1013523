"""The benchmark's own tests: run from the repository root with

    python -m pytest perfbench/tests -q

They import the harness (perfbench/pb), the reference (perfbench/reference)
and, where they compare with it, the program. Tests marked `cuda` need the
card and skip without one."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips the test without a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda")
