"""Test config: force the CPU backend with 8 virtual devices so sharding
paths are exercised without accelerator hardware (SURVEY.md §4 item 6)."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent compile cache: the suite is compile-time dominated (big jits);
# caching executables across runs cuts repeat wall time.
from jax_bvh.config import use_compile_cache

use_compile_cache(min_compile_secs=0.3)
jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def cornellbox_tris():
    from jax_bvh.utils import scenes

    return scenes.cornellbox()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def random_tris(rng, n, spread=10.0, size=0.5):
    """Random triangle soup with varied scales."""
    base = rng.uniform(-spread, spread, size=(n, 1, 3))
    offs = rng.normal(0.0, size, size=(n, 3, 3))
    return (base + offs).astype(np.float32)
