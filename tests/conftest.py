"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding logic
(mesh/shard_map/collectives) is exercised without GPUs, per SURVEY.md
section 4.3. Environment must be set before jax is imported. The GPU
path is checked on a card by chip_smoke.py.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# Pin the CPU backend via the config API before any backend is
# initialized, whatever the environment's JAX_PLATFORMS says.
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Bound accumulated compiler state: with ~100+ distinct compilations in
    one process, jaxlib 0.9's CPU backend_compile occasionally segfaults
    late in the suite. Dropping live executables between modules keeps the
    per-process compilation footprint small (costs a few re-compiles for
    fixtures shared across modules)."""
    yield
    jax.clear_caches()
