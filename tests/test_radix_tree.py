"""Radix-tree topology tests: both builders against a direct-recursion golden
model, including degenerate duplicate-code scenes (the reference's index
tie-break path, `TwoPassLbvhKernel.h:32-40`)."""
import numpy as np
import pytest
import jax.numpy as jnp

from jax_bvh.ops import radix_tree
from jax_bvh.utils.validate import reference_radix_tree_ranges


def _ranges_from_topology(left, right, n):
    """Recover each internal node's leaf range by DFS."""
    n_internal = n - 1
    ranges = {}

    def rec(idx):
        if idx >= n_internal:
            leaf = idx - n_internal
            return leaf, leaf
        l0, l1 = rec(int(left[idx]))
        r0, r1 = rec(int(right[idx]))
        assert l1 + 1 == r0, "children must be adjacent in sorted-leaf space"
        ranges[idx] = (l0, r1)
        return l0, r1

    # find root: node never referenced as child
    seen = set()
    for i in range(n_internal):
        seen.add(int(left[i]))
        seen.add(int(right[i]))
    roots = [i for i in range(n_internal) if i not in seen]
    assert len(roots) == 1
    full = rec(roots[0])
    assert full == (0, n - 1)
    return sorted(ranges.values()), roots[0]


CODE_SETS = [
    np.array([0b000, 0b001, 0b100, 0b101, 0b110, 0b111], dtype=np.uint32),
    np.array([1, 2, 3, 4, 5, 6, 7, 8], dtype=np.uint32),
    np.array([5, 5, 5, 5], dtype=np.uint32),  # all-duplicate codes
    np.array([0, 0, 1, 1, 1, 7, 7, 200, 200, 200, 200, 4000], dtype=np.uint32),
    np.array([0, 4294967295], dtype=np.uint32),
    np.array([123, 123], dtype=np.uint32),
]


@pytest.mark.parametrize("codes", CODE_SETS, ids=range(len(CODE_SETS)))
@pytest.mark.parametrize("builder", ["karras", "apetrei"])
def test_topology_matches_golden(codes, builder):
    n = len(codes)
    jc = jnp.asarray(codes)
    if builder == "karras":
        left, right, parent, first, last = radix_tree.karras_topology(jc)
    else:
        left, right, parent, first, last, root = radix_tree.apetrei_topology(jc)
    left = np.asarray(left)
    right = np.asarray(right)
    got_ranges, got_root = _ranges_from_topology(left, right, n)
    want = reference_radix_tree_ranges(codes)
    assert got_ranges == want
    if builder == "apetrei":
        assert int(root) == got_root
    else:
        assert got_root == 0

    # reported first/last must match the DFS-derived ranges per node
    for i in range(n - 1):
        lo, hi = None, None
        # recompute this node's range from children
        pass
    # parent consistency
    parent = np.asarray(parent)
    for i in range(2 * n - 1):
        p = parent[i]
        if p >= 0:
            assert left[p] == i or right[p] == i


@pytest.mark.parametrize("builder", ["karras", "apetrei"])
@pytest.mark.parametrize("n", [2, 3, 17, 257, 1000])
def test_topology_random(builder, n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 2**30, size=n, dtype=np.uint32)
    codes = np.sort(codes)
    jc = jnp.asarray(codes)
    if builder == "karras":
        left, right, *_ = radix_tree.karras_topology(jc)
    else:
        left, right, _p, _f, _l, _root = radix_tree.apetrei_topology(jc)
    got_ranges, _ = _ranges_from_topology(np.asarray(left), np.asarray(right), n)
    want = reference_radix_tree_ranges(codes)
    assert got_ranges == want


@pytest.mark.parametrize("builder", ["karras", "apetrei"])
def test_reported_ranges_match_dfs(builder):
    rng = np.random.default_rng(7)
    n = 300
    codes = np.sort(rng.integers(0, 2**20, size=n, dtype=np.uint32))
    jc = jnp.asarray(codes)
    if builder == "karras":
        left, right, _p, first, last = radix_tree.karras_topology(jc)
    else:
        left, right, _p, first, last, _root = radix_tree.apetrei_topology(jc)
    left, right = np.asarray(left), np.asarray(right)
    first, last = np.asarray(first), np.asarray(last)
    n_internal = n - 1

    def dfs_range(idx):
        if idx >= n_internal:
            leaf = idx - n_internal
            return leaf, leaf
        l0, _ = dfs_range(int(left[idx]))
        _, r1 = dfs_range(int(right[idx]))
        return l0, r1

    import sys

    sys.setrecursionlimit(10000)
    for i in range(n_internal):
        lo, hi = dfs_range(i)
        assert (first[i], last[i]) == (lo, hi)
