"""The benchmark's own CPU tests (``python3 -m pytest benchmark/tests``):
small shapes, the kernels' plain versions, one torch thread."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(1)


@pytest.fixture
def root():
    return ROOT
