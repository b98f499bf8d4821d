"""The benchmark's own CPU tests: ``python -m pytest perfbench/tests``.

The harness's modules are top-level modules of ``perfbench/`` (the
directory ``run.py`` runs from); the checkout's root holds the port.
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
