"""Vectorized AABB and triangle math.

SoA equivalents of the reference's `Aabb` class and
`intersectTriangle` (`src/Common.h:310-416,516-531`). All
functions operate on batched `[..., 3]` min/max arrays; there are no atomics —
reductions are plain `jnp` reductions, which XLA lowers to deterministic
tree reductions.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..types import FLT_MAX


def empty_aabb(shape=()):
    """An 'inverted' AABB that is the identity of `union`."""
    mn = jnp.full(shape + (3,), FLT_MAX, jnp.float32)
    mx = jnp.full(shape + (3,), -FLT_MAX, jnp.float32)
    return mn, mx


def union(amin, amax, bmin, bmax):
    """`Aabb::grow(Aabb)` / `merge` (`Common.h:333-338,456-459`)."""
    return jnp.minimum(amin, bmin), jnp.maximum(amax, bmax)


def center(amin, amax):
    return (amin + amax) * 0.5


def extent(amin, amax):
    return amax - amin


def area(amin, amax):
    """Surface area, `Aabb::area` (`Common.h:361-365`)."""
    e = amax - amin
    return 2.0 * (e[..., 0] * e[..., 1] + e[..., 0] * e[..., 2] + e[..., 1] * e[..., 2])


def max_extent_dim(amin, amax):
    """`Aabb::maximumExtentDim` (`Common.h:351-359`): 0 if x strictly largest
    vs y and z, else 1 if y > z, else 2."""
    d = amax - amin
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return jnp.where((x > y) & (x > z), 0, jnp.where(y > z, 1, 2)).astype(jnp.int32)


def offset(amin, amax, p):
    """Normalized position of p inside the box, `Aabb::offset`
    (`Common.h:367-374`); axes with zero extent pass the raw offset through."""
    o = p - amin
    e = amax - amin
    return jnp.where(e > 0, o / jnp.where(e > 0, e, 1.0), o)


def triangle_aabbs(tris):
    """Per-triangle AABB. tris: f32[N, 3, 3] (vertex-major)."""
    return jnp.min(tris, axis=-2), jnp.max(tris, axis=-2)


def slab_intersect(amin, amax, origin, inv_dir, max_t):
    """Slab test, `Aabb::intersect(from, invRay, maxt)` (`Common.h:384-397`).

    Returns (t_near, t_far); hit iff t_near <= t_far. Shapes broadcast:
    amin/amax [..., 3], origin/inv_dir [..., 3], max_t [...].
    """
    d_far = (amax - origin) * inv_dir
    d_near = (amin - origin) * inv_dir
    t_far = jnp.min(jnp.maximum(d_far, d_near), axis=-1)  # minFar
    t_near = jnp.max(jnp.minimum(d_far, d_near), axis=-1)  # maxNear
    t_far = jnp.minimum(max_t, t_far)
    t_near = jnp.maximum(0.0, t_near)
    return t_near, t_far


def intersect_triangle(v0, v1, v2, ray_org, ray_dir):
    """Watertight-style triangle test returning (u, v, w, t), the exact
    formulation of `intersectTriangle` (`Common.h:516-531`). A hit requires
    u, v, w, t all > 0 and t below the current closest t (checked by callers,
    see `TraversalKernel.h:86-91`)."""
    pos0 = v0 - ray_org
    pos1 = v1 - ray_org
    pos2 = v2 - ray_org
    edge0 = v2 - v0
    edge1 = v0 - v1
    edge2 = v1 - v2
    normal = jnp.cross(edge1, edge0)
    u = jnp.sum(jnp.cross(pos0 + pos2, edge0) * ray_dir, axis=-1)
    v = jnp.sum(jnp.cross(pos1 + pos0, edge1) * ray_dir, axis=-1)
    w = jnp.sum(jnp.cross(pos2 + pos1, edge2) * ray_dir, axis=-1)
    t = jnp.sum(pos0 * normal, axis=-1) * 2.0
    denom = jnp.sum(normal * ray_dir, axis=-1) * 2.0
    inv = 1.0 / denom
    return u * inv, v * inv, w * inv, t * inv


def qt_rotate(q, p):
    """Rotate vector p by quaternion q=(x,y,z,w), `qtRotate`
    (`Common.h:502-508`)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, p)
    return p + qw * t + jnp.cross(qv, t)


def qt_invert(q):
    return jnp.concatenate([-q[..., :3], q[..., 3:]], axis=-1)


def qt_inv_rotate(q, p):
    return qt_rotate(qt_invert(q), p)


def qt_rotation(axis_angle):
    """Axis-angle -> quaternion, `qtRotation` (`Common.h:461-472`)."""
    axis = axis_angle[..., :3]
    axis = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    angle = axis_angle[..., 3:]
    return jnp.concatenate(
        [axis * jnp.sin(angle / 2.0), jnp.cos(angle / 2.0)], axis=-1
    )


def transform_point(p, scale, quat, translation):
    """`transform` (`Common.h:514`)."""
    return qt_rotate(quat, scale * p) + translation


def inv_transform_point(p, scale, quat, translation):
    """`invTransform` (`Common.h:512`)."""
    return qt_inv_rotate(quat, p - translation) / scale
