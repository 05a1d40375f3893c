"""CPU tests of the benchmark (``python -m pytest benchmark/tests``). Tests marked ``card``
need a CUDA card and skip here; on the card machine they run with ``-m card``."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size runs only on the card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """A temporary checkout holding the benchmark's files and the tiny cells."""
    from benchmark.harness.cells import Layout
    from tiny_layout import tiny_layout

    return Layout(tiny_layout(tmp_path_factory.mktemp("checkout")))
