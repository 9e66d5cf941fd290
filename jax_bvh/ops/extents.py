"""Scene extent reduction.

Replaces the warp-shuffle / block-shared-memory / global-atomicGrow reduction
stack of the reference (`CommonBlocksKernel.h:27-137`) with plain `jnp`
min/max reductions — XLA lowers these to deterministic tree reductions;
no atomics are needed and the result is
bit-reproducible (the reference's float-atomic version is not).
"""
from __future__ import annotations

import jax.numpy as jnp


def scene_extents(aabb_min, aabb_max):
    """Whole-scene AABB from per-primitive AABBs.

    Equivalent of `CalculateSceneExtents` / `CalculatePrimRefExtents`
    (`CommonBlocksKernel.h:92-137`). Returns (scene_min f32[3],
    scene_max f32[3]).
    """
    return jnp.min(aabb_min, axis=0), jnp.max(aabb_max, axis=0)
