"""Shared fixtures of the benchmark's own tests (run from the repository
root: ``python -m pytest slam_bench/tests``)."""
import pytest


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
