"""BVH2 -> BVH4 collapse as a slab-streamed BFS.

The reference runs a persistent kernel spinning on a global task queue with
atomic slot allocation (`src/TwoPassLbvhKernel.h:237-337`).
This version streams the same BFS task queue in fixed-size slabs:

* every bvh2 node is pre-packed into a 12-lane **int32** row (child ids,
  area bits, AABB bits) so each child access during expansion is ONE
  row-gather. The row is i32, never f32: int ids bitcast into f32 are
  denormals, which fusions may flush to zero (floats ride as bits
  instead; non-negative floats are order-isomorphic to
  their i32 bit patterns, so the area argmax stays in i32 too);
* a `lax.while_loop` carries a cursor (start, alloc) over the task queue;
  each iteration processes the slab [start, start+B) with `dynamic_slice`
  (static size, dynamic offset), expands every task's largest-area internal
  child twice (<= 4 children, `TwoPassLbvhKernel.h:270-296`), allocates
  child slots with an exclusive cumsum, writes results back with
  `dynamic_update_slice`, and enqueues new tasks contiguously;
* processing strictly in queue order with cumsum allocation makes the node
  numbering deterministic and byte-identical to the sequential CPU oracle
  (`Utility.cpp:540-611`), which the tests enforce.

Gather volume is ~6 rows per task total (vs. whole-array gathers per BFS
level), independent of tree depth.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..types import Bvh2, Bvh4
from . import aabb as A

I32 = jnp.int32
INVALID = jnp.int32(-1)
SLAB = 4096


def _f_bits(x):
    """Float -> i32 bit pattern (safe carriage; see module doc)."""
    return lax.bitcast_convert_type(x, I32)


def _bits_f(x):
    return lax.bitcast_convert_type(x, jnp.float32)


@jax.jit
def collapse_bvh2_to_bvh4(bvh: Bvh2) -> Bvh4:
    n_leaves = bvh.n_leaves
    n2_int = bvh.n_internal
    mm = bvh.n_nodes
    cap = max(n2_int, 1)
    slab = min(SLAB, max(cap, 8))  # XLA CPU chokes on degenerate 1-wide slabs
    # dynamic_slice/update_slice clamp out-of-range offsets, which would
    # silently shift the last slab — pad the queue/output arrays instead
    cap_pad = cap + slab

    pk = bvh.packed_t  # f32[6, M] lane-major (min xyz, -max xyz)
    ext = jnp.maximum(-pk[3:6] - pk[0:3], 0.0)
    areas = 2.0 * (ext[0] * ext[1] + ext[0] * ext[2] + ext[1] * ext[2])
    # packed per-node i32 row: [left, right, areaBits, minBits3, maxBits3,
    # pad3] -> 12 (areas are >= 0, so their bit patterns order like floats).
    # Assembled lane-major then transposed once (a direct [M, 12] concat
    # pays the 128-lane minor-dim pad ~10x over).
    prow = jnp.concatenate(
        [
            bvh.left.astype(I32)[None, :],
            bvh.right.astype(I32)[None, :],
            _f_bits(areas)[None, :],
            _f_bits(pk[0:3]),
            _f_bits(-pk[3:6]),
            jnp.zeros((3, mm), I32),
        ],
        axis=0,
    ).T

    def fetch(ids):
        return prow[jnp.clip(ids, 0, mm - 1)]

    def body(carry):
        (
            start,
            alloc,
            tq_id,
            tq_parent,
            child,
            cmin,
            cmax,
            parent,
            child_count,
            leaf_prim,
            leaf_parent,
        ) = carry
        lane = jnp.arange(slab, dtype=I32)
        gidx = start + lane  # global task/wide-node index
        active = gidx < alloc

        task_b2 = lax.dynamic_slice(tq_id, (start,), (slab,))
        task_par = lax.dynamic_slice(tq_parent, (start,), (slab,))
        trow = fetch(task_b2)
        l_id = trow[:, 0]
        r_id = trow[:, 1]
        ids = jnp.stack([l_id, r_id, jnp.full_like(l_id, INVALID), jnp.full_like(l_id, INVALID)], axis=1)
        rowdata = jnp.stack(
            [fetch(l_id), fetch(r_id), jnp.zeros((slab, 12), I32), jnp.zeros((slab, 12), I32)],
            axis=1,
        )
        count = jnp.full((slab,), 2, I32)
        slot_ids = jnp.arange(4, dtype=I32)[None, :]

        for _ in range(2):
            in_slot = slot_ids < count[:, None]
            is_int = in_slot & (ids >= 0) & (ids < n2_int)
            # area bits compare like floats (areas >= 0); -1 sentinel loses
            slot_area = jnp.where(is_int, rowdata[:, :, 2], -1)
            pos = jnp.argmax(slot_area, axis=1).astype(I32)
            best = jnp.max(slot_area, axis=1)
            do = active & (best > 0)  # strict >0 like the reference's maxArea=0
            onehot = slot_ids == pos[:, None]
            chosen_row = rowdata[:, 0]
            for k in range(1, 4):
                chosen_row = jnp.where(
                    (pos == k)[:, None], rowdata[:, k], chosen_row
                )
            cl = chosen_row[:, 0]
            cr = chosen_row[:, 1]
            row_cl = fetch(cl)
            row_cr = fetch(cr)
            ids = jnp.where(do[:, None] & onehot, cl[:, None], ids)
            ids = jnp.where(
                do[:, None] & (slot_ids == count[:, None]), cr[:, None], ids
            )
            rowdata = jnp.where(
                (do[:, None] & onehot)[:, :, None], row_cl[:, None, :], rowdata
            )
            rowdata = jnp.where(
                (do[:, None] & (slot_ids == count[:, None]))[:, :, None],
                row_cr[:, None, :],
                rowdata,
            )
            count = jnp.where(do, count + 1, count)

        in_slot = slot_ids < count[:, None]
        is_int_child = active[:, None] & in_slot & (ids >= 0) & (ids < n2_int)
        is_leaf_child = active[:, None] & in_slot & (ids >= n2_int)

        flat_int = is_int_child.reshape(-1)
        ranks = jnp.cumsum(flat_int.astype(I32)) - flat_int.astype(I32)
        new_ids = (alloc + ranks).reshape(slab, 4)
        n_new = jnp.sum(flat_int.astype(I32))

        child_slab = jnp.where(
            is_int_child,
            new_ids,
            jnp.where(is_leaf_child, cap + (ids - n2_int), INVALID),
        )
        cmin_slab = rowdata[:, :, 3:6]  # f32 bits carried as i32
        cmax_slab = rowdata[:, :, 6:9]

        # contiguous write-back of this slab's wide nodes
        child = lax.dynamic_update_slice(child, child_slab, (start, 0))
        cmin = lax.dynamic_update_slice(cmin, cmin_slab, (start, 0, 0))
        cmax = lax.dynamic_update_slice(cmax, cmax_slab, (start, 0, 0))
        parent = lax.dynamic_update_slice(parent, task_par, (start,))
        child_count = lax.dynamic_update_slice(
            child_count, jnp.where(active, count, 0), (start,)
        )

        # enqueue internal children contiguously at [alloc, alloc+n_new)
        tq_tgt = jnp.where(is_int_child, new_ids, cap).reshape(-1)
        tq_id = tq_id.at[tq_tgt].set(ids.reshape(-1), mode="drop")
        tq_parent = tq_parent.at[tq_tgt].set(
            jnp.repeat(gidx, 4), mode="drop"
        )

        # wide leaves
        leaf_slot = jnp.where(is_leaf_child, ids - n2_int, n_leaves).reshape(-1)
        leaf_prim_vals = rowdata[:, :, 0].reshape(-1)  # leaf's left = prim
        leaf_prim = leaf_prim.at[leaf_slot].set(leaf_prim_vals, mode="drop")
        leaf_parent = leaf_parent.at[leaf_slot].set(
            jnp.repeat(gidx, 4), mode="drop"
        )

        # advance past what was actually processed: only tasks allocated
        # BEFORE this round (reads of later enqueues would be stale)
        start = jnp.minimum(start + slab, alloc)
        alloc = alloc + n_new
        return (
            start,
            alloc,
            tq_id,
            tq_parent,
            child,
            cmin,
            cmax,
            parent,
            child_count,
            leaf_prim,
            leaf_parent,
        )

    def cond(carry):
        start, alloc, *_ = carry
        return start < alloc

    carry = (
        jnp.zeros((), I32),
        jnp.ones((), I32),
        jnp.full((cap_pad,), INVALID).at[0].set(bvh.root.astype(I32)),
        jnp.full((cap_pad,), INVALID),
        jnp.full((cap_pad, 4), INVALID),
        jnp.zeros((cap_pad, 4, 3), I32),
        jnp.zeros((cap_pad, 4, 3), I32),
        jnp.full((cap_pad,), INVALID),
        jnp.zeros((cap_pad,), I32),
        jnp.full((n_leaves,), INVALID),
        jnp.full((n_leaves,), INVALID),
    )
    carry = lax.while_loop(cond, body, carry)
    (
        _start,
        alloc,
        _tq_id,
        _tq_parent,
        child,
        cmin,
        cmax,
        parent,
        child_count,
        leaf_prim,
        leaf_parent,
    ) = carry
    return Bvh4.from_rowmajor(
        child_min=_bits_f(cmin[:cap]),
        child_max=_bits_f(cmax[:cap]),
        child=child[:cap],
        parent=parent[:cap],
        child_count=child_count[:cap],
        n_nodes=alloc,
        leaf_prim=leaf_prim,
        leaf_parent=leaf_parent,
    )
