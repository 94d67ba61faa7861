"""Tests of the benchmark harness. They run on the CPU at small sizes; the
tests marked `cuda` need a card and skip without one.

    python -m pytest vo_bench/tests -q

from the root of the repository (on a machine with a CUDA device: the same
command)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
