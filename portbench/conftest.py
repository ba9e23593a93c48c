"""pytest settings of the benchmark's own tests (``python -m pytest portbench``).

Tests marked ``cuda`` need a CUDA card; the ``card`` fixture decides that
when a test runs, never when a module is imported, and skips with the
reason on a machine without one.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (runs on the chip only)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return torch.device("cuda")
