"""Test config: determinism pins + import paths.

NOTE: no XLA_FLAGS here — single-device tests must see one device (the
multi-device collective/integration tests spawn subprocesses with their own
xla_force_host_platform_device_count).  Tier-1 runs deterministically: CPU
platform, x64 off, fixed seeds for every RNG the tests touch.
"""
import os
import random
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")   # before jax import

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.dirname(__file__))   # for the _hyp shim

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute distributed/e2e cases (deselect with "
        "-m 'not slow' for the quick tier-1 loop)")
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _pin_host_rngs():
    """Host-side RNGs re-seeded per test; jax code must use explicit
    PRNGKeys (the `rng_key` fixture) anyway."""
    random.seed(0)
    np.random.seed(0)
    yield


@pytest.fixture
def rng_key():
    return jax.random.PRNGKey(0)
