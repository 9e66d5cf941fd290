"""SAH cost metrics — the reference's quality/regression oracle.

jnp re-implementations of `calculateLbvhCost` / `calculatebvh4Cost` /
`calculateBinnedSahBvhCost` (`src/Utility.cpp:317-422`),
formula-exact (ci = ct = 1, areas normalized by the root area, root counted
once at ct). Expected parity values: bunny ~22.6 / sponza ~59.5 post
collapse (`README.md:61,81`).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops import aabb as A

# SAH regression pins for the procedural stand-in scenes at their default
# sizes (`scenes.sponza_like(262_000)` = 261,996 tris, `scenes.bunny_like()`
# = 149,604 tris): scene -> {builder: BVH2 SAH, "bvh4": collapsed
# single-pass SAH}. These are this repo's own values (the reference's
# bunny/sponza meshes are not available), recorded from earlier runs of the
# same builders; a check allows 1% drift.
SAH_PINS = {
    "sponza_like": {
        "single_pass": 333.01,
        "two_pass": 333.01,
        "ploc": 280.94,
        "hploc": 281.14,
        "bvh4": 159.13,
    },
    "bunny_like": {
        "single_pass": 51.90,
        "two_pass": 51.90,
        "ploc": 49.60,
        "hploc": 50.25,
    },
}


def sah_cost_bvh2(bvh) -> jnp.ndarray:
    """`calculateLbvhCost` (`Utility.cpp:317-349`): ct for the root + ct per
    internal-node child + ci per leaf, all area-weighted."""
    n_internal = bvh.n_internal
    areas = A.area(bvh.node_min, bvh.node_max)
    root = bvh.root
    inv_root = 1.0 / areas[root]
    left = bvh.left[:n_internal]
    right = bvh.right[:n_internal]
    cost = 1.0
    cost = cost + jnp.sum(areas[left] * inv_root) + jnp.sum(areas[right] * inv_root)
    cost = cost + jnp.sum(areas[n_internal:] * inv_root)
    return cost


def sah_cost_bvh4(bvh4, prim_aabb_min, prim_aabb_max) -> jnp.ndarray:
    """`calculatebvh4Cost` (`Utility.cpp:351-396`): ct per wide internal
    child + ci per wide leaf (leaf areas from the *original* primitive
    AABBs), normalized by the root AABB area. Works directly on the
    lane-major slot store (f32[4, 6, K]) — no [K, 4, 3] materialization."""
    cap = bvh4.n_internal_cap
    child_t = bvh4.child_t  # i32[4,K]
    sp = bvh4.slot_packed_t  # f32[4, 6, K] (min xyz, -max xyz)

    ext = jnp.maximum(-sp[:, 3:6, :] - sp[:, 0:3, :], 0.0)  # [4, 3, K]
    child_areas = 2.0 * (
        ext[:, 0] * ext[:, 1] + ext[:, 0] * ext[:, 2] + ext[:, 1] * ext[:, 2]
    )  # [4, K]

    root_valid = child_t[:, bvh4.root] >= 0  # [4]
    root_pk = jnp.min(
        jnp.where(root_valid[:, None], sp[:, :, bvh4.root], jnp.inf), axis=0
    )  # [6] packed union (min xyz, -max xyz)
    root_ext = jnp.maximum(-root_pk[3:6] - root_pk[0:3], 0.0)
    inv_root = 1.0 / (
        2.0
        * (
            root_ext[0] * root_ext[1]
            + root_ext[0] * root_ext[2]
            + root_ext[1] * root_ext[2]
        )
    )

    # used-slot mask by child_count: holds for both the dense queue-ordered
    # numbering (used slots = prefix) and the sparse fast-collapse numbering
    is_used = (bvh4.child_count > 0)[None, :]
    is_internal_child = (child_t >= 0) & (child_t < cap) & is_used  # [4, K]
    cost = 1.0 + jnp.sum(jnp.where(is_internal_child, child_areas, 0.0)) * inv_root

    leaf_areas = A.area(prim_aabb_min[bvh4.leaf_prim], prim_aabb_max[bvh4.leaf_prim])
    cost = cost + jnp.sum(leaf_areas) * inv_root
    return cost
