"""The benchmark's tests: the repository's root on the path, one PyTorch
thread a test process (several test processes on a busy machine stall each
other's thread pools), and the card fixture (decided inside a fixture,
never at import)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    import torch

    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """The card, for the card tests; they skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.fixture
def no_card():
    """For the tests of a run without a card; they skip on a card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
