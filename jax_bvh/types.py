"""Core data model for the BVH engine.

Struct-of-arrays re-expression of the reference's AoS node formats
(`src/Common.h:429-591`). Everything is a flat JAX array so
that builders, refit passes and traversal are pure jittable functions.

Index convention (matches the reference, `TwoPassLbvhKernel.h:145-152`):
for an N-leaf BVH2 the node array has 2N-1 slots; internal nodes occupy
[0, N-2], leaves occupy [N-1, 2N-2]. A node index >= n_internal IS a leaf and
the leaf's `left` field holds the primitive index. We deviate in one place:
the reference uses u32 with INVALID = 0xFFFFFFFF; we use int32 with
INVALID = -1 (friendlier to XLA gathers).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

INVALID_IDX = jnp.int32(-1)
FLT_MAX = jnp.float32(3.402823466e38)
_ZERO_I32 = jnp.int32(0)

# Tuning constants mirroring the reference's src/Common.h:593-597.
PLOC_RADIUS = 8
MAX_BATCHED_PRIMS = 32


class Bvh2(NamedTuple):
    """Binary BVH in SoA layout. M = 2N-1 node slots.

    Replaces the reference's `Bvh2Node {left,right,Aabb}` array
    (`Common.h:436-441`). Leaves live in slots [N-1, 2N-2] in Morton-sorted
    order; a leaf's `left` is the primitive index (into the original,
    unsorted triangle array), `right` is INVALID.

    Node AABBs are stored LANE-MAJOR as `packed_t` f32[6, M] with rows
    (min x, min y, min z, -max x, -max y, -max z), so each coordinate is
    one contiguous row. Negated maxes make every range union a single
    `minimum`.
    Use the `node_min` / `node_max` properties for row-major views (they
    pay one transpose); hot paths should consume `packed_t` directly.
    """

    packed_t: jax.Array  # f32[..., 6, M] rows = (min xyz, -max xyz)
    left: jax.Array  # i32[..., M]
    right: jax.Array  # i32[..., M]
    root: jax.Array  # i32[...] scalar — 0 for Karras/PLOC, traced for Apetrei

    @property
    def node_min(self) -> jax.Array:
        """Row-major f32[..., M, 3] view (pays a relayout — prefer packed_t)."""
        return jnp.swapaxes(self.packed_t[..., 0:3, :], -1, -2)

    @property
    def node_max(self) -> jax.Array:
        return -jnp.swapaxes(self.packed_t[..., 3:6, :], -1, -2)

    @classmethod
    def from_rows(cls, node_min, node_max, left, right, root) -> "Bvh2":
        packed = jnp.concatenate([node_min, -node_max], axis=-1)
        return cls(
            packed_t=jnp.swapaxes(packed, -1, -2),
            left=left, right=right, root=root,
        )

    @property
    def n_nodes(self) -> int:
        return self.left.shape[-1]

    @property
    def n_leaves(self) -> int:
        return (self.left.shape[-1] + 1) // 2

    @property
    def n_internal(self) -> int:
        return self.n_leaves - 1


class Bvh4(NamedTuple):
    """4-wide BVH produced by collapsing a Bvh2.

    Replaces `Bvh4Node {4xAabb, 4xchild, parent, childCount}`
    (`Common.h:560-566`) plus the `PrimNode` leaf array (`Common.h:568-571`).
    Child index `c < n_internal_cap` refers to another wide node; otherwise it
    refers to wide leaf slot `c - n_internal_cap` (matching the reference's
    `childIdx < nBvh2InternalNodes` leaf test in `CollapseToWide4Bvh`).

    Slot AABBs are stored lane-major (`slot_packed_t[k, :, x]` = slot k of
    wide node x as (min xyz, -max xyz)) — the layout the collapse kernel
    emits and the SAH evaluator consumes. Child ids are likewise
    lane-major (`child_t` i32[4, K]).
    `child`/`child_min`/`child_max` are row-major convenience views for
    oracles and tests.
    """

    slot_packed_t: jax.Array  # f32[4, 6, K] (min xyz, -max xyz per slot)
    child_t: jax.Array  # i32[4, K] (INVALID for empty slots)
    parent: jax.Array  # i32[K]
    child_count: jax.Array  # i32[K]
    n_nodes: jax.Array  # i32[] number of wide internal nodes actually used
    leaf_prim: jax.Array  # i32[N] prim index per wide leaf slot
    leaf_parent: jax.Array  # i32[N]
    # Root wide-node index. The queue-ordered collapse re-roots to 0 like
    # the reference (`SinglePassLbvh.cpp:183`); the blocked fast collapse
    # keeps sparse bvh2-id numbering (wide node x occupies slot x, unused
    # slots have child_count == 0), where the root keeps its bvh2 index.
    root: jax.Array = _ZERO_I32

    @property
    def n_internal_cap(self) -> int:
        """Static capacity of the wide-internal-node array; also the leaf
        index bias (leaf slot = child - n_internal_cap)."""
        return self.child_t.shape[-1]

    @property
    def child(self) -> jax.Array:
        """Row-major i32[K, 4] view (oracle/test interface — pays the
        minor-dim lane pad; hot paths should consume `child_t`)."""
        return self.child_t.T

    @property
    def child_min(self) -> jax.Array:
        """Row-major view f32[K, 4, 3] (oracle/test interface)."""
        return self.slot_packed_t[:, 0:3, :].transpose(2, 0, 1)

    @property
    def child_max(self) -> jax.Array:
        """Row-major view f32[K, 4, 3] (oracle/test interface)."""
        return -self.slot_packed_t[:, 3:6, :].transpose(2, 0, 1)

    @classmethod
    def from_rowmajor(cls, child_min, child_max, child, **kw) -> "Bvh4":
        """Construct from `[K, 4, 3]` slot AABBs + `[K, 4]` child ids
        (non-production paths)."""
        sp = jnp.concatenate(
            [child_min.transpose(1, 2, 0), -child_max.transpose(1, 2, 0)],
            axis=1,
        )
        return cls(slot_packed_t=sp, child_t=child.T, **kw)


class PrimRefs(NamedTuple):
    """Primitive references: one AABB + source-prim index per reference.

    Replaces `PrimRef` (`Common.h:574-578`). With early split clipping off
    (the reference default, saMax=FltMax) this is exactly one ref per
    triangle.
    """

    aabb_min: jax.Array  # f32[R, 3]
    aabb_max: jax.Array  # f32[R, 3]
    prim_idx: jax.Array  # i32[R]


class Camera(NamedTuple):
    """Pinhole camera, mirroring `Camera` (`Common.h:550-558`)."""

    eye: jax.Array  # f32[3]
    quat: jax.Array  # f32[4] (x, y, z, w)
    fov: jax.Array  # f32[] radians
    near: jax.Array  # f32[]
    far: jax.Array  # f32[]


class Transformation(NamedTuple):
    """Object-to-world SRT transform, mirroring `Transformation`
    (`Common.h:541-548`)."""

    translation: jax.Array  # f32[3]
    scale: jax.Array  # f32[3]
    quat: jax.Array  # f32[4]


class Rays(NamedTuple):
    """Ray SoA, replacing `Ray` (`Common.h:533-539`)."""

    origin: jax.Array  # f32[R, 3]
    direction: jax.Array  # f32[R, 3]
    tmin: jax.Array  # f32[R]
    tmax: jax.Array  # f32[R]


class HitInfo(NamedTuple):
    """Closest-hit record SoA, replacing `HitInfo` (`Common.h:580-585`)."""

    prim_idx: jax.Array  # i32[R]
    t: jax.Array  # f32[R]
    u: jax.Array  # f32[R]
    v: jax.Array  # f32[R]


def identity_transform() -> Transformation:
    return Transformation(
        translation=jnp.zeros(3, jnp.float32),
        scale=jnp.ones(3, jnp.float32),
        quat=jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
    )
