"""The benchmark's own tests: `python -m pytest perfbench/tests -o
addopts=""` on the CPU; those marked `cuda` run on the card and skip
without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (runs the cells on the card)")


@pytest.fixture(autouse=True)
def _card(request):
    if request.node.get_closest_marker("cuda") is not None:
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
