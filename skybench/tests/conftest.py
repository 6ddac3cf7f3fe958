"""Shared fixtures of the benchmark's own tests. Tests that need an NVIDIA
card carry the ``cuda`` marker and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the benchmark's runs); skipped without one"
    )


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")
    return torch.cuda.get_device_name(0)
