"""The benchmark's tests import ``perfbench`` and the port from the checkout
root; the card is looked for inside a fixture, never at import."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with "
                    "`python -m pytest perfbench/tests -q -m cuda`")
    return torch.device("cuda")
