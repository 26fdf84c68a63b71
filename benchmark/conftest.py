"""pytest settings of the benchmark's own tests (``benchmark/tests``).

    python3 -m pytest benchmark/tests -q            # on the CPU: the card tests skip
    python3 -m pytest benchmark/tests -q -m card    # on a CUDA card

Tests that need a CUDA card carry the ``card`` marker and take the ``card``
fixture, which decides when the test runs whether a card is present.
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda", 0)
