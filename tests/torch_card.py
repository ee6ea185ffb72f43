"""Shared fixture of the port's tests that need an NVIDIA card.

A test marked `cuda` takes the `cuda_device` fixture, which skips it
(with the reason) when no card is present.  The decision is made when
the fixture runs, never at import or collection, so every pytest-xdist
worker collects the same tests.
"""

import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
