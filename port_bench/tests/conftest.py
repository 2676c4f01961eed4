import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, decided when a test asks for it; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"

