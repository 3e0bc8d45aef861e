"""pytest settings of the benchmark's own tests (python -m pytest benchmark/tests).

The marker `card` marks a test that needs a CUDA card; such a test asks for
the `card` fixture, which skips it where torch sees no card.  Whether there
is a card is decided inside the fixture, never at import."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (runs on the chip; skips here)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `python -m pytest benchmark/tests -m card` on the chip")
    return torch.device("cuda:0")
