"""Tests of the benchmark's harness. They run on the CPU at cut sizes; a
test that needs the card is marked `cuda` and decides in a fixture whether
it skips."""

import pytest


@pytest.fixture
def cuda_device():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size on the card")
    return torch.device("cuda")
