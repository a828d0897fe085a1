"""Shared settings of the benchmark's own tests (CPU unless marked ``gpu``)."""

import pytest
import torch

# A cell at a size a CPU test run holds: a 0.2% graph, a 0.1 MB cache (so
# both caches miss), two presampling batches, batches of 64 seeds.
SMALL = {"scale": 0.002, "config": {"cache_mb": 0.1, "n_presample": 2}, "mix": {"batch_size": 64}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skipped (by a fixture) where there is none"
    )


@pytest.fixture(autouse=True)
def few_threads():
    """Two threads a test: the suite runs in several workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def small():
    """Overrides that shrink a cell for a CPU run (``run_cell(overrides=)``)."""
    return {k: dict(v) if isinstance(v, dict) else v for k, v in SMALL.items()}


@pytest.fixture
def served(small):
    """``small`` for the served cell, at 40 requests a second."""
    small["mix"]["rate_per_s"] = 40
    return small


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())
