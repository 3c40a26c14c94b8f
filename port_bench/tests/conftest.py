"""The benchmark's tests. Tests that need an NVIDIA card carry the ``card``
marker and skip, with their reason, where none is visible: the fixture
decides when the test runs, never while a module is imported."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (runs on the chip only)")
    # the tiny CPU runs gain nothing from more threads, and test workers share the cores
    torch.set_num_threads(2)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the chip: "
                    "python3 -m pytest port_bench/tests -m card")
    return torch.device("cuda")
