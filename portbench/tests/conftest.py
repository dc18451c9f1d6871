"""Shared fixtures of the benchmark's own tests (run from the repository's
root: `python -m pytest portbench/tests -q`)."""
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _at_root(monkeypatch):
    """The harness reads BENCHMARK.json and the bundled data from the
    checkout's root."""
    monkeypatch.chdir(ROOT)
    torch.set_num_threads(min(4, os.cpu_count() or 1))


@pytest.fixture
def card():
    """Skip where no CUDA device is present (decided here, never at
    import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
