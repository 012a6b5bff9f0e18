"""pytest settings of the benchmark's own tests (run them with
``python -m pytest benchmark/tests -q``; the repository's suite does not
collect them)."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips (with its reason) "
        "where there is none, deciding inside the test")


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
