"""Early split clipping: pre-split large-AABB primitives into multiple
PrimRefs before the build.

Equivalent of the host-side `Utility::doEarlySplitClipping`
(`src/Utility.cpp:456-538`), which midpoint-splits a prim's
AABB along its max axis while `area > saMax`. The reference default
(saMax = FltMax, `TwoPassLbvh.cpp:22-32`) makes it the identity. This stays
a host (numpy) preprocessing step, but the queue becomes vectorized rounds:
each round splits *every* oversized ref at once.
"""
from __future__ import annotations

import numpy as np


def _area(mn, mx):
    e = mx - mn
    return 2.0 * (e[:, 0] * e[:, 1] + e[:, 0] * e[:, 2] + e[:, 1] * e[:, 2])


def early_split_clipping(tris: np.ndarray, sa_max: float = np.inf, max_rounds: int = 32):
    """tris f32[N,3,3] -> (aabb_min f32[R,3], aabb_max f32[R,3],
    prim_idx i32[R]) with every ref's AABB area <= sa_max.

    Splitting halves the AABB at its center along the max-extent axis (the
    reference clips the *box*, not the triangle — ditto here)."""
    mn = tris.min(axis=1).astype(np.float32)
    mx = tris.max(axis=1).astype(np.float32)
    idx = np.arange(tris.shape[0], dtype=np.int32)
    if not np.isfinite(sa_max):
        return mn, mx, idx

    done_mn, done_mx, done_idx = [], [], []
    for _ in range(max_rounds):
        area = _area(mn, mx)
        small = area <= sa_max
        if small.all():
            break
        done_mn.append(mn[small])
        done_mx.append(mx[small])
        done_idx.append(idx[small])
        mn, mx, idx = mn[~small], mx[~small], idx[~small]

        ext = mx - mn
        dim = np.where(
            (ext[:, 0] > ext[:, 1]) & (ext[:, 0] > ext[:, 2]),
            0,
            np.where(ext[:, 1] > ext[:, 2], 1, 2),
        )
        center = (mn + mx) * 0.5
        rows = np.arange(mn.shape[0])
        l_mx = mx.copy()
        l_mx[rows, dim] = center[rows, dim]
        r_mn = mn.copy()
        r_mn[rows, dim] = center[rows, dim]
        mn = np.concatenate([mn, r_mn], axis=0)
        mx = np.concatenate([l_mx, mx], axis=0)
        idx = np.concatenate([idx, idx], axis=0)

    done_mn.append(mn)
    done_mx.append(mx)
    done_idx.append(idx)
    return (
        np.concatenate(done_mn, axis=0),
        np.concatenate(done_mx, axis=0),
        np.concatenate(done_idx, axis=0),
    )
