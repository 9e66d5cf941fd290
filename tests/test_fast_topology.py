"""The gather-free threshold-scan topologies must match the search-based
reference implementations bit-for-bit (they feed the production builders)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jax_bvh.ops import radix_tree


def _codes(n, seed, bits=30):
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, 2**bits, size=n).astype(np.uint32))


CASES = [
    _codes(2, 0),
    _codes(3, 1),
    _codes(64, 2),
    _codes(257, 3),
    _codes(400, 4, bits=4),  # heavy duplicates
    np.zeros(100, np.uint32),  # all duplicates
]


@pytest.mark.parametrize("codes", CASES, ids=range(len(CASES)))
def test_apetrei_fast_matches(codes):
    jc = jnp.asarray(codes)
    a = radix_tree.apetrei_topology(jc)
    b = radix_tree.apetrei_topology_fast(jc)
    for name, x, y in zip(["left", "right", "parent", "first", "last", "root"], a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), name


@pytest.mark.parametrize("codes", CASES, ids=range(len(CASES)))
def test_karras_fast_matches(codes):
    jc = jnp.asarray(codes)
    a = radix_tree.karras_topology(jc)
    b = radix_tree.karras_topology_fast(jc)
    for name, x, y in zip(["left", "right", "parent", "first", "last"], a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), name
