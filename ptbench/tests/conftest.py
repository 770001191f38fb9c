"""Tests of the benchmark harness (ptbench/).

CPU tests drive the harness at tiny sizes with the port's plain route.
Tests marked `card` need a CUDA device and skip without one:
`python -m pytest ptbench/tests -m card` on the machine with the card.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (run on the card: "
        "python -m pytest ptbench/tests -m card); skips without one")


@pytest.fixture(autouse=True)
def few_torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
