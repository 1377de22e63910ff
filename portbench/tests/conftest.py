"""The benchmark's own tests: ``python -m pytest portbench/tests`` from the
root of the checkout, on the CPU; on the machine with the card the tests
marked ``cuda`` run too (``-m cuda``), skipping elsewhere from inside a
fixture."""

import os
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)
