"""Key-value sort of (Morton code, primitive index) pairs.

Replaces the vendored `Oro::RadixSort` (usage at
`src/TwoPassLbvh.cpp:73-89`). `lax.sort` lowers to XLA's
on-device sort, run UNSTABLE over the total key (code, original index):
because the index tiebreak is unique, the 2-key unstable sort reproduces the stable-by-code order byte-for-byte — the
canonical leaf order the sharded and batched reimplementations are
tested bit-identical against.
"""
from __future__ import annotations

from jax import lax


def sort_pairs(codes, values):
    """Ascending key-value sort by (codes, values) — total order when
    `values` are unique (prim indices). codes: u32[n], values: i32[n]."""
    out = lax.sort((codes, values), num_keys=2, is_stable=False)
    return out[0], out[1]


def sort_with_payload(codes, payload):
    """Ascending sort of `codes` carrying a tuple of payload arrays;
    payload[0] must be a unique index channel — it is the tiebreak key,
    making the order the canonical (code, index) total order.

    Returns (sorted_codes, tuple(sorted_payload)). The build front end's
    sort phase (`src/TwoPassLbvh.cpp:73-89` sorts
    (mortonKey, primIdx); here the leaf AABB columns ride along so the
    post-sort gather disappears)."""
    out = lax.sort((codes, *payload), num_keys=2, is_stable=False)
    return out[0], tuple(out[1:])
