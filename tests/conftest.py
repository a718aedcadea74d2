import os
import sys

# smoke tests and benches must see exactly ONE device (the dry-run forces
# 512 in its own process only)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import pytest  # noqa: E402

from repro.configs.base import list_configs  # noqa: E402

ASSIGNED = [a for a in list_configs() if not a.startswith("tiny-")]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (skipped without)")


@pytest.fixture(scope="session")
def rng():
    return jax.random.key(0)
