"""Test configuration: run everything on a virtual 8-device CPU mesh.

This is the JAX-native 'fake backend' the reference lacks (SURVEY.md §4):
multi-device sharding tests execute on host CPU with
--xla_force_host_platform_device_count=8. The environment is set before
anything imports jax, which reads it once at start-up.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Every test not marked slow/heavy is 'core': `pytest -m core` is
    the sub-3-minute iteration subset."""
    for item in items:
        if ("slow" not in item.keywords) and ("heavy" not in item.keywords):
            item.add_marker(pytest.mark.core)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
