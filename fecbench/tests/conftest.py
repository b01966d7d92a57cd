"""Settings of the benchmark's own tests (`python -m pytest fecbench/tests`).

Tests that need a CUDA card carry the `card` marker and ask for the
`card` fixture, which decides at run time whether there is one and skips
with a reason where there is not.  Nothing here imports JAX."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card, and torch sees none")
    return torch.cuda.device_count()
