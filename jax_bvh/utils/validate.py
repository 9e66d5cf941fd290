"""Structural invariant checkers — the reference's debug oracles as pure
numpy functions (pytest-friendly).

Ports of the checkers in `src/Utility.cpp:15-159`, which the
reference runs as `_DEBUG` asserts after every build. Here they are real
tests (see tests/).
"""
from __future__ import annotations

import numpy as np


def _as_np(x):
    return np.asarray(x)


def check_root_aabb(bvh) -> bool:
    """Root AABB equals the reduction of all leaf AABBs
    (`Utility::checkLbvhRootAabb`, `Utility.cpp:15-27`)."""
    node_min = _as_np(bvh.node_min)
    node_max = _as_np(bvh.node_max)
    n_internal = bvh.n_internal
    root = int(_as_np(bvh.root))
    leaf_min = node_min[n_internal:]
    leaf_max = node_max[n_internal:]
    return bool(
        np.array_equal(leaf_min.min(axis=0), node_min[root])
        and np.array_equal(leaf_max.max(axis=0), node_max[root])
    )


def collect_leaf_prims(bvh) -> np.ndarray:
    """DFS from root collecting leaf primitive ids
    (`Utility::checkLBvhCorrectness`, `Utility.cpp:31-60`)."""
    left = _as_np(bvh.left)
    right = _as_np(bvh.right)
    n_internal = bvh.n_internal
    root = int(_as_np(bvh.root))
    prims = []
    stack = [root]
    while stack:
        idx = stack.pop()
        if idx >= n_internal:
            prims.append(left[idx])
        else:
            stack.append(int(left[idx]))
            stack.append(int(right[idx]))
    return np.array(prims)


def check_bvh2_correctness(bvh, n_prims: int | None = None) -> bool:
    """Every primitive appears exactly once under the root."""
    prims = collect_leaf_prims(bvh)
    n = bvh.n_leaves
    uniq = np.unique(prims)
    ok = len(prims) == n and len(uniq) == n
    if n_prims is not None:
        # With identity PrimRefs leaf prims are a permutation of [0, n).
        ok = ok and uniq.min() == 0 and uniq.max() == n_prims - 1
    return bool(ok)


def check_parent_child_consistency(bvh) -> bool:
    """Internal node AABBs contain their children (tree is a valid BVH)."""
    node_min = _as_np(bvh.node_min)
    node_max = _as_np(bvh.node_max)
    left = _as_np(bvh.left)
    right = _as_np(bvh.right)
    n_internal = bvh.n_internal
    for i in range(n_internal):
        l, r = left[i], right[i]
        want_min = np.minimum(node_min[l], node_min[r])
        want_max = np.maximum(node_max[l], node_max[r])
        if not (np.array_equal(want_min, node_min[i]) and np.array_equal(want_max, node_max[i])):
            return False
    return True


def check_bvh4_correctness(bvh4, n_prims: int) -> bool:
    """4-wide tree visits every primitive exactly once
    (`Utility::checkLBvh4Correctness`, `Utility.cpp:93-130`)."""
    child = _as_np(bvh4.child)
    leaf_prim = _as_np(bvh4.leaf_prim)
    cap = bvh4.n_internal_cap
    prims = []
    stack = [int(_as_np(bvh4.root))]
    while stack:
        idx = stack.pop()
        if idx >= cap:
            prims.append(leaf_prim[idx - cap])
        else:
            for c in child[idx]:
                if c >= 0:
                    stack.append(int(c))
    prims = np.array(prims)
    uniq = np.unique(prims)
    return bool(len(prims) == n_prims and len(uniq) == n_prims)


def reference_radix_tree_ranges(codes: np.ndarray) -> list[tuple[int, int]]:
    """Golden model: the set of leaf ranges of the radix tree over sorted
    (code, index) keys, built by direct recursion. Both LBVH topologies must
    produce exactly this set of ranges."""
    n = len(codes)
    keys = [(int(codes[i]) << 32) | i for i in range(n)]

    def delta(a, b):
        # common prefix length of 64-bit keys
        x = keys[a] ^ keys[b]
        return 64 - x.bit_length()

    ranges = []

    def rec(l, r):
        if l == r:
            return
        # split = position of minimum adjacent similarity in [l, r-1]
        best, arg = None, l
        for j in range(l, r):
            d = delta(j, j + 1)
            if best is None or d < best:
                best, arg = d, j
        ranges.append((l, r))
        rec(l, arg)
        rec(arg + 1, r)

    rec(0, n - 1)
    return sorted(ranges)
