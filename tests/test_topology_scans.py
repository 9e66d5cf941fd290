"""V=64 threshold-plane topology scans vs independent numpy oracles.

Covers ties (duplicate Morton codes) heavily: tie deltas use the index
tie-break, so the PSV/NSV and child-position scans are pinned against a
sequential stack oracle, a brute-force PSV/NSV search, and
`np.minimum.accumulate` / `np.maximum.accumulate` planes.
"""
from __future__ import annotations

import numpy as np
import pytest
import jax.numpy as jnp

from jax_bvh.ops import radix_tree

BIG = 2**31 - 1


def _codes(kind: str, n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        c = rng.integers(0, 1 << 30, size=n, dtype=np.uint32)
    elif kind == "dups":
        # heavy duplicate runs — every tie path exercised
        c = rng.integers(0, 64, size=n, dtype=np.uint32) * 1024
    elif kind == "all_equal":
        c = np.full(n, 12345, np.uint32)
    elif kind == "sorted_line":
        c = (np.arange(n, dtype=np.uint32)) * 7
    else:
        raise ValueError(kind)
    return np.sort(c)


def _stack_oracle(full):
    """Sequential oracle over remapped deltas: (psv_pos, psv_val, lc,
    nsv_pos, nsv_val, rc) by monotone stacks and range argmins."""
    m = full.shape[0]
    psv_pos = np.full(m, -1, np.int64)
    psv_val = np.full(m, -1, np.int64)
    nsv_pos = np.full(m, m, np.int64)
    nsv_val = np.full(m, -1, np.int64)
    lc = np.full(m, -1, np.int64)
    rc = np.full(m, -1, np.int64)
    stack: list[int] = []
    for i in range(m):
        while stack and full[stack[-1]] >= full[i]:
            stack.pop()
        if stack:
            psv_pos[i] = stack[-1]
            psv_val[i] = full[stack[-1]]
        stack.append(i)
    stack = []
    for i in range(m - 1, -1, -1):
        while stack and full[stack[-1]] >= full[i]:
            stack.pop()
        if stack:
            nsv_pos[i] = stack[-1]
            nsv_val[i] = full[stack[-1]]
        stack.append(i)
    for i in range(m):
        lo, hi = psv_pos[i], i
        if hi - lo > 1:
            lc[i] = lo + 1 + int(np.argmin(full[lo + 1 : hi]))
        lo, hi = i, nsv_pos[i]
        if hi - lo > 1:
            rc[i] = lo + 1 + int(np.argmin(full[lo + 1 : hi]))
    return psv_pos, psv_val, lc, nsv_pos, nsv_val, rc


def _remapped(codes_np):
    d = np.asarray(radix_tree.adjacent_deltas(jnp.asarray(codes_np)))
    return np.where(d <= 31, d - 2, d - 11).astype(np.int64)


@pytest.mark.parametrize("kind", ["random", "dups", "all_equal", "sorted_line"])
@pytest.mark.parametrize("n", [97, 4096, 4097, 9000])
def test_topology_scans_match_stack_oracle(kind, n):
    codes_np = _codes(kind, n)
    dlt, first, last, psv_val, nsv_val, psv, lc, rc = [
        np.asarray(x) for x in radix_tree._topology_scans(jnp.asarray(codes_np))
    ]
    full = _remapped(codes_np)
    want = _stack_oracle(full)
    np.testing.assert_array_equal(dlt, full)
    got = (psv, psv_val, lc, last, nsv_val, rc)
    names = ["psv_pos", "psv_val", "lc", "nsv_pos", "nsv_val", "rc"]
    for g, w, name in zip(got, want, names):
        bad = np.nonzero(g != w)[0]
        assert bad.size == 0, (
            f"{name} mismatch at {bad[:5]}: got {g[bad[:5]]} want {w[bad[:5]]}"
        )
    np.testing.assert_array_equal(first, psv + 1)


def test_oracle_against_search_topology():
    """The stack oracle agrees with the search-based (sparse-table) topology."""
    codes_np = _codes("dups", 2000, seed=7)
    _l, _r, _p, first, last, _root = radix_tree.apetrei_topology(
        jnp.asarray(codes_np)
    )
    psv_pos, _pv, _lc, nsv_pos, _nv, _rc = _stack_oracle(_remapped(codes_np))
    np.testing.assert_array_equal(psv_pos + 1, np.asarray(first))
    np.testing.assert_array_equal(nsv_pos, np.asarray(last))


def _psv_nsv_brute(dlt):
    """Packed previous/next strictly-smaller values by direct search."""
    m = dlt.shape[0]
    psv = np.full(m, -1, np.int64)
    nsv = np.full(m, BIG, np.int64)
    for i in range(m):
        left = np.nonzero(dlt[:i] < dlt[i])[0]
        if left.size:
            j = left[-1]
            psv[i] = j * 64 + dlt[j]
        right = np.nonzero(dlt[i + 1 :] < dlt[i])[0]
        if right.size:
            j = i + 1 + right[0]
            nsv[i] = j * 64 + dlt[j]
    return psv, nsv


@pytest.mark.parametrize("m", [512, 513, 1024, 2000])
@pytest.mark.parametrize("seed", [0, 1])
def test_psv_nsv_packed_matches_brute_force(m, seed):
    rng = np.random.default_rng(seed * 1000 + m)
    dlt = rng.integers(0, 53, size=m).astype(np.int32)
    p, n = radix_tree.psv_nsv_packed(jnp.asarray(dlt))
    want_p, want_n = _psv_nsv_brute(dlt)
    np.testing.assert_array_equal(np.asarray(p), want_p)
    np.testing.assert_array_equal(np.asarray(n), want_n)


@pytest.mark.parametrize("dist", ["all_equal", "ascending", "descending"])
def test_psv_nsv_packed_degenerate(dist):
    m = 700
    dlt = {
        "all_equal": np.zeros(m, np.int32),
        "ascending": (np.arange(m) % 53).astype(np.int32),
        "descending": (52 - np.arange(m) % 53).astype(np.int32),
    }[dist]
    p, n = radix_tree.psv_nsv_packed(jnp.asarray(dlt))
    want_p, want_n = _psv_nsv_brute(dlt)
    np.testing.assert_array_equal(np.asarray(p), want_p)
    np.testing.assert_array_equal(np.asarray(n), want_n)


def test_payload_scan_matches_brute_force():
    rng = np.random.default_rng(42)
    m = 3000
    dlt = rng.integers(0, 53, m).astype(np.int32)
    pay = rng.integers(0, 2**22, m).astype(np.int32)
    psv, pp, nsv, npay = [
        np.asarray(x)
        for x in radix_tree.psv_nsv_payload(jnp.asarray(dlt), jnp.asarray(pay))
    ]
    want_p, want_n = _psv_nsv_brute(dlt)
    np.testing.assert_array_equal(psv, want_p)
    np.testing.assert_array_equal(nsv, want_n)
    np.testing.assert_array_equal(
        pp, np.where(want_p >= 0, pay[np.clip(want_p >> 6, 0, m - 1)], -1)
    )
    np.testing.assert_array_equal(
        npay, np.where(want_n != BIG, pay[np.clip(want_n >> 6, 0, m - 1)], -1)
    )


@pytest.mark.parametrize("plane", ["psv", "nsv"])
@pytest.mark.parametrize("m", [512, 1000, 1024, 1537])
@pytest.mark.parametrize("dist", ["random", "dups"])
def test_threshold_planes_match_numpy_accumulate(plane, m, dist):
    """Exclusive prefix-max (psv) / suffix-min (nsv) planes vs
    `np.maximum.accumulate` / `np.minimum.accumulate` per lane."""
    rng = np.random.default_rng(m + len(dist) + len(plane))
    hi = 53 if dist == "random" else 4
    dlt = rng.integers(0, hi, size=m).astype(np.int32)
    psv_rows, nsv_rows, onehot = [
        np.asarray(x) for x in radix_tree._threshold_planes(jnp.asarray(dlt))
    ]
    packed = np.arange(m, dtype=np.int64) * 64 + dlt
    lanes = np.arange(64)
    live = dlt[:, None] < lanes[None, :]
    if plane == "psv":
        x = np.where(live, packed[:, None], -1)
        inc = np.maximum.accumulate(x, axis=0)
        want = np.concatenate([np.full((1, 64), -1), inc[:-1]], axis=0)
        got = psv_rows
    else:
        x = np.where(live, packed[:, None], BIG)
        inc = np.minimum.accumulate(x[::-1], axis=0)[::-1]
        want = np.concatenate([inc[1:], np.full((1, 64), BIG)], axis=0)
        got = nsv_rows
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(onehot, dlt[:, None] == lanes[None, :])
