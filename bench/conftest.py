"""pytest settings of the benchmark's own tests (``bench/tests/``): the
``cuda`` marker, and ``bench/`` and the port's sources on the path.
Whether a card exists is decided inside a fixture, never at import."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# appended, not prepended: tests/ imports its own conftest by name
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.append(p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped on a machine without")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
