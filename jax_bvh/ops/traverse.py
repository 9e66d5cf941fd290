"""Wavefront BVH2 traversal — the four reference shader schedules.

The reference's four per-thread traversal kernels
(`src/TraversalKernel.h:28-451`) differ only in how they
schedule node tests vs leaf tests around SIMT divergence. Here the ray
population is a dense SoA and every step is a masked vector op, so the
variants become step schedulers of one wavefront engine:

* `if_if`        — one unit of work per ray per iteration (node OR leaf),
                   the direct analog of `BvhTraversalifif`.
* `while_while`  — a few node steps then a leaf step per iteration
                   (`BvhTraversalWhile`'s inner loops, unrolled).
* `speculative`  — node steps until *every* active ray has found a leaf,
                   then one batched leaf phase: the vector-wide reading of
                   `!__any(searchingLeaf)` (`TraversalKernel.h:403-411`).
* `restart_trail`— stackless bit-trail traversal (`TraversalKernel.h:28-146`)
                   with the u64 trail emulated as a pair of u32 words.

Per-ray stacks are an `i32[R, DEPTH]` array in HBM; near-child-first
ordering, closest-hit semantics, world-space triangle tests against an
object-space AABB walk exactly as the reference does (including its mixed
t-space `min(maxt, ...)` clamp, `TraversalKernel.h:68-71,96-99`).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..types import Bvh2, HitInfo, Rays, Transformation, FLT_MAX
from . import aabb as A

I32 = jnp.int32
INVALID = jnp.int32(-1)
STACK_DEPTH = 48


def _transform_rays(rays: Rays, tr: Transformation):
    origin = A.inv_transform_point(rays.origin, tr.scale, tr.quat, tr.translation)
    zero = jnp.zeros(3, jnp.float32)
    direction = A.inv_transform_point(rays.direction, tr.scale, tr.quat, zero)
    inv_dir = 1.0 / direction
    return origin, inv_dir


def _node_step(bvh: Bvh2, t_origin, t_inv_dir, node, stack, top, hit_t, active, ovf):
    """One internal-node step for the masked ray set: test both children,
    go near-first, push far; pop on miss. Returns updated
    (node, stack, top, ovf); `ovf` records rays that wanted a push while the
    stack was full (their results are recomputed by the stackless fallback
    — the reference silently drops the far child here,
    `TraversalKernel.h:160,214`, a latent wrong-hit bug we do NOT inherit)."""
    n_internal = bvh.n_internal
    safe = jnp.clip(node, 0, bvh.n_nodes - 1)
    l = bvh.left[safe]
    r = bvh.right[safe]
    sl = jnp.clip(l, 0, bvh.n_nodes - 1)
    sr = jnp.clip(r, 0, bvh.n_nodes - 1)
    t0n, t0f = A.slab_intersect(
        bvh.node_min[sl], bvh.node_max[sl], t_origin, t_inv_dir, hit_t
    )
    t1n, t1f = A.slab_intersect(
        bvh.node_min[sr], bvh.node_max[sr], t_origin, t_inv_dir, hit_t
    )
    hit_l = t0n <= t0f
    hit_r = t1n <= t1f
    both = hit_l & hit_r
    near = jnp.where(t0n < t1n, l, r)
    far = jnp.where(t0n < t1n, r, l)

    want_push = active & both
    do_push = want_push & (top < STACK_DEPTH)
    ovf = ovf | (want_push & (top >= STACK_DEPTH))
    ray_ids = jnp.arange(node.shape[0], dtype=I32)
    stack = stack.at[ray_ids, jnp.where(do_push, top, 0)].set(
        jnp.where(do_push, far, stack[:, 0])
    )
    top = jnp.where(do_push, top + 1, top)

    next_hit = jnp.where(both, near, jnp.where(hit_l, l, r))
    any_hit = hit_l | hit_r
    # pop on miss
    top_pop = jnp.maximum(top - 1, 0)
    popped = stack[ray_ids, top_pop]
    node_new = jnp.where(any_hit, next_hit, popped)
    top = jnp.where(active & ~any_hit, top_pop, top)
    node = jnp.where(active, node_new, node)
    return node, stack, top, ovf


def _leaf_step(bvh: Bvh2, tris, tr: Transformation, rays: Rays, node, stack, top, hit, counts, active):
    """One leaf step: world-space triangle test + closest-hit update + pop."""
    ray_ids = jnp.arange(node.shape[0], dtype=I32)
    safe = jnp.clip(node, 0, bvh.n_nodes - 1)
    prim = jnp.clip(bvh.left[safe], 0, tris.shape[0] - 1)
    tri = tris[prim]  # [R, 3, 3]
    tv = A.transform_point(tri, tr.scale, tr.quat, tr.translation)
    u, v, w, t = A.intersect_triangle(
        tv[:, 0], tv[:, 1], tv[:, 2], rays.origin, rays.direction
    )
    is_hit = active & (u > 0) & (v > 0) & (w > 0) & (t > 0) & (t < hit.t)
    hit = HitInfo(
        prim_idx=jnp.where(is_hit, bvh.left[safe], hit.prim_idx),
        t=jnp.where(is_hit, t, hit.t),
        u=jnp.where(is_hit, u, hit.u),
        v=jnp.where(is_hit, v, hit.v),
    )
    counts = counts + active.astype(jnp.uint32)
    top_pop = jnp.maximum(top - 1, 0)
    node = jnp.where(active, stack[ray_ids, top_pop], node)
    top = jnp.where(active, top_pop, top)
    return node, top, hit, counts


def _init_state(bvh: Bvh2, rays: Rays):
    n_rays = rays.origin.shape[0]
    node = jnp.full((n_rays,), 0, I32) + bvh.root
    stack = jnp.full((n_rays, STACK_DEPTH), INVALID, I32)
    top = jnp.ones((n_rays,), I32)  # slot 0 holds the INVALID sentinel
    hit = HitInfo(
        prim_idx=jnp.full((n_rays,), INVALID, I32),
        t=jnp.full((n_rays,), FLT_MAX, jnp.float32),
        u=jnp.zeros(n_rays, jnp.float32),
        v=jnp.zeros(n_rays, jnp.float32),
    )
    counts = jnp.zeros(n_rays, jnp.uint32)
    return node, stack, top, hit, counts


@partial(jax.jit, static_argnames=("variant",))
def traverse_bvh2(
    bvh: Bvh2,
    tris,
    rays: Rays,
    tr: Transformation,
    variant: str = "speculative",
):
    """Closest-hit traversal of all rays. Returns (HitInfo, leaf-visit
    counts u32[R] — the reference's `rayCounter` heat-map signal,
    `TraversalKernel.h:191`)."""
    if variant == "restart_trail":
        return _traverse_restart_trail(bvh, tris, rays, tr)

    t_origin, t_inv_dir = _transform_rays(rays, tr)
    n_internal = bvh.n_internal
    node, stack, top, hit, counts = _init_state(bvh, rays)
    ovf = jnp.zeros(node.shape[0], bool)

    node_steps = {"if_if": 1, "while_while": 4, "speculative": 0}[variant]

    def cond(carry):
        node, *_ = carry
        return jnp.any(node != INVALID)

    def body(carry):
        node, stack, top, hit, counts, ovf = carry
        alive = node != INVALID
        if variant == "speculative":
            # inner: advance node phase until no active ray sits at an
            # internal node (the `!__any(searchingLeaf)` vote)
            def icond(c):
                nd, *_ = c
                return jnp.any((nd != INVALID) & (nd < n_internal))

            def ibody(c):
                nd, st, tp, h, ov = c
                act = (nd != INVALID) & (nd < n_internal)
                nd, st, tp, ov = _node_step(
                    bvh, t_origin, t_inv_dir, nd, st, tp, h.t, act, ov
                )
                return nd, st, tp, h, ov

            node, stack, top, hit, ovf = lax.while_loop(
                icond, ibody, (node, stack, top, hit, ovf)
            )
        else:
            for _ in range(node_steps):
                act = (node != INVALID) & (node < n_internal)
                node, stack, top, ovf = _node_step(
                    bvh, t_origin, t_inv_dir, node, stack, top, hit.t, act, ovf
                )
        leaf_act = (node != INVALID) & (node >= n_internal)
        node, top, hit, counts = _leaf_step(
            bvh, tris, tr, rays, node, stack, top, hit, counts, leaf_act
        )
        # rays whose node is still internal continue; ifif does its node step
        # next iteration
        if variant == "if_if":
            pass
        return node, stack, top, hit, counts, ovf

    node, stack, top, hit, counts, ovf = lax.while_loop(
        cond, body, (node, stack, top, hit, counts, ovf)
    )
    # Overflowed rays (tree deeper than the stack: degenerate Morton
    # caterpillars) re-traverse through the stackless restart-trail engine —
    # correct for any depth. When no ray overflowed the fallback loop body
    # never executes.
    hit, counts = _restart_trail_engine(
        _bvh2_fetch(bvh, tris),
        n_internal,
        bvh.root,
        rays,
        tr,
        t_origin,
        t_inv_dir,
        ~ovf,
        _reset_hit(hit, ovf),
        jnp.where(ovf, jnp.uint32(0), counts),
    )
    return hit, counts


def pack_bvh2(bvh: Bvh2, tris):
    """Traversal-optimized layout: one i32[16] row per node.

    Internal row: [min_l(3), max_l(3), min_r(3), max_r(3), left, right, -, -]
    Leaf row:     [v0(3), v1(3), v2(3), prim, -, ...]
    Float fields ride as i32 bit patterns — NOT the other way around:
    int indices bitcast into f32 lanes are denormals, which fusions may
    flush to zero. A traversal step then needs exactly ONE row-gather
    instead of six. The reference gets the same effect from SIMT caches;
    this layout makes it explicit. Built once per scene, reused across
    frames.
    """
    ni = bvh.n_internal
    mm = bvh.n_nodes
    l = jnp.clip(bvh.left[:ni], 0, mm - 1)
    r = jnp.clip(bvh.right[:ni], 0, mm - 1)

    def bits(x):
        return lax.bitcast_convert_type(x, I32)

    # child AABB rows from the lane-major store: gather columns of [6, M]
    # (row-major node_min views would pay the minor-dim-3 relayout first)
    pk = bits(bvh.packed_t)  # i32[6, M] (min xyz, -max xyz bits)
    neg = jnp.int32(1) << 31
    col_l = pk[:, l]  # [6, ni]
    col_r = pk[:, r]
    internal = jnp.concatenate(
        [
            col_l[0:3],
            col_l[3:6] ^ neg,  # flip sign bit: bits(-x) == bits(x) ^ 2^31
            col_r[0:3],
            col_r[3:6] ^ neg,
            bvh.left[:ni].astype(I32)[None, :],
            bvh.right[:ni].astype(I32)[None, :],
            jnp.zeros((2, ni), I32),
        ],
        axis=0,
    ).T
    prim = jnp.clip(bvh.left[ni:], 0, tris.shape[0] - 1)
    tv = bits(tris[prim].reshape(-1, 9))
    leaf = jnp.concatenate(
        [
            tv,
            bvh.left[ni:].astype(I32)[:, None],
            jnp.zeros((mm - ni, 6), I32),
        ],
        axis=1,
    )
    return jnp.concatenate([internal, leaf], axis=0)


@partial(jax.jit, static_argnames=())
def traverse_packed(packed, n_internal, root, rays: Rays, tr: Transformation):
    """Wavefront traversal over the packed layout — ONE gather per step.

    Fused schedule (each active ray does one unit of work per iteration,
    leaf or internal, off a single row fetch). Same results as
    `traverse_bvh2`; this is the throughput path.
    """
    mm = packed.shape[0]
    n_rays = rays.origin.shape[0]
    t_origin, t_inv_dir = _transform_rays(rays, tr)

    def as_f(x):
        return lax.bitcast_convert_type(x, jnp.float32)

    node = jnp.zeros((n_rays,), I32) + root
    stack = jnp.full((n_rays, STACK_DEPTH), INVALID, I32)
    top = jnp.ones((n_rays,), I32)
    hit = HitInfo(
        prim_idx=jnp.full((n_rays,), INVALID, I32),
        t=jnp.full((n_rays,), FLT_MAX, jnp.float32),
        u=jnp.zeros(n_rays, jnp.float32),
        v=jnp.zeros(n_rays, jnp.float32),
    )
    counts = jnp.zeros(n_rays, jnp.uint32)
    ovf0 = jnp.zeros(n_rays, bool)
    ray_ids = jnp.arange(n_rays, dtype=I32)

    def body(c):
        node, stack, top, hit, counts, ovf = c
        alive = node != INVALID
        is_leaf = alive & (node >= n_internal)
        act_int = alive & ~is_leaf
        row = packed[jnp.clip(node, 0, mm - 1)]  # i32 [R, 16]

        # internal interpretation: two-child slab test
        l_idx = row[:, 12]
        r_idx = row[:, 13]
        t0n, t0f = A.slab_intersect(
            as_f(row[:, 0:3]), as_f(row[:, 3:6]), t_origin, t_inv_dir, hit.t
        )
        t1n, t1f = A.slab_intersect(
            as_f(row[:, 6:9]), as_f(row[:, 9:12]), t_origin, t_inv_dir, hit.t
        )
        hit_l = t0n <= t0f
        hit_r = t1n <= t1f
        both = hit_l & hit_r
        near = jnp.where(t0n < t1n, l_idx, r_idx)
        far = jnp.where(t0n < t1n, r_idx, l_idx)
        want_push = act_int & both
        do_push = want_push & (top < STACK_DEPTH)
        ovf = ovf | (want_push & (top >= STACK_DEPTH))
        stack = stack.at[ray_ids, jnp.where(do_push, top, 0)].set(
            jnp.where(do_push, far, stack[:, 0])
        )
        top = jnp.where(do_push, top + 1, top)
        next_int = jnp.where(both, near, jnp.where(hit_l, l_idx, r_idx))
        int_miss = act_int & ~(hit_l | hit_r)

        # leaf interpretation: world-space triangle test off the same row
        v0 = A.transform_point(as_f(row[:, 0:3]), tr.scale, tr.quat, tr.translation)
        v1 = A.transform_point(as_f(row[:, 3:6]), tr.scale, tr.quat, tr.translation)
        v2 = A.transform_point(as_f(row[:, 6:9]), tr.scale, tr.quat, tr.translation)
        u, v, w, t = A.intersect_triangle(v0, v1, v2, rays.origin, rays.direction)
        prim = row[:, 9]
        good = is_leaf & (u > 0) & (v > 0) & (w > 0) & (t > 0) & (t < hit.t)
        hit = HitInfo(
            prim_idx=jnp.where(good, prim, hit.prim_idx),
            t=jnp.where(good, t, hit.t),
            u=jnp.where(good, u, hit.u),
            v=jnp.where(good, v, hit.v),
        )
        counts = counts + is_leaf.astype(jnp.uint32)

        pop_t = jnp.maximum(top - 1, 0)
        popped = stack[ray_ids, pop_t]
        need_pop = is_leaf | int_miss
        node = jnp.where(
            act_int & ~int_miss, next_int, jnp.where(need_pop, popped, node)
        )
        top = jnp.where(need_pop, pop_t, top)
        return node, stack, top, hit, counts, ovf

    def cond(c):
        return jnp.any(c[0] != INVALID)

    node, stack, top, hit, counts, ovf = lax.while_loop(
        cond, body, (node, stack, top, hit, counts, ovf0)
    )
    # stack-overflowed rays re-traverse via the stackless engine (no-op
    # loop when ovf is all-False)
    hit, counts = _restart_trail_engine(
        _packed_fetch(packed), n_internal, root, rays, tr,
        t_origin, t_inv_dir, ~ovf, _reset_hit(hit, ovf),
        jnp.where(ovf, jnp.uint32(0), counts),
    )
    return hit, counts


def _reset_hit(hit: HitInfo, mask):
    """Fresh HitInfo where `mask`, passthrough elsewhere."""
    return HitInfo(
        prim_idx=jnp.where(mask, INVALID, hit.prim_idx),
        t=jnp.where(mask, FLT_MAX, hit.t),
        u=jnp.where(mask, 0.0, hit.u),
        v=jnp.where(mask, 0.0, hit.v),
    )


def _bvh2_fetch(bvh: Bvh2, tris):
    """Node fetcher over the plain Bvh2 SoA for the restart-trail engine."""
    n_nodes = bvh.n_nodes

    def fetch(node):
        safe = jnp.clip(node, 0, n_nodes - 1)
        l = bvh.left[safe]
        r = bvh.right[safe]
        sl = jnp.clip(l, 0, n_nodes - 1)
        sr = jnp.clip(r, 0, n_nodes - 1)
        prim_c = jnp.clip(l, 0, tris.shape[0] - 1)
        tri = tris[prim_c]
        return (
            bvh.node_min[sl], bvh.node_max[sl],
            bvh.node_min[sr], bvh.node_max[sr],
            l, r,
            tri[:, 0], tri[:, 1], tri[:, 2], l,
        )

    return fetch


def _packed_fetch(packed):
    """Node fetcher over the packed one-row-per-node layout (`pack_bvh2`)."""
    mm = packed.shape[0]

    def as_f(x):
        return lax.bitcast_convert_type(x, jnp.float32)

    def fetch(node):
        row = packed[jnp.clip(node, 0, mm - 1)]  # i32 [R, 16]
        f = as_f(row[:, 0:12])
        return (
            f[:, 0:3], f[:, 3:6], f[:, 6:9], f[:, 9:12],
            row[:, 12], row[:, 13],
            f[:, 0:3], f[:, 3:6], f[:, 6:9], row[:, 9],
        )

    return fetch


def _traverse_restart_trail(bvh: Bvh2, tris, rays: Rays, tr: Transformation):
    """Stackless restart-trail traversal (`TraversalKernel.h:28-146`)."""
    t_origin, t_inv_dir = _transform_rays(rays, tr)
    n_rays = rays.origin.shape[0]
    hit = HitInfo(
        prim_idx=jnp.full((n_rays,), INVALID, I32),
        t=jnp.full((n_rays,), FLT_MAX, jnp.float32),
        u=jnp.zeros(n_rays, jnp.float32),
        v=jnp.zeros(n_rays, jnp.float32),
    )
    counts = jnp.zeros(n_rays, jnp.uint32)
    return _restart_trail_engine(
        _bvh2_fetch(bvh, tris), bvh.n_internal, bvh.root, rays, tr,
        t_origin, t_inv_dir, jnp.zeros(n_rays, bool), hit, counts,
    )


def _restart_trail_engine(
    fetch, n_internal, root, rays: Rays, tr: Transformation,
    t_origin, t_inv_dir, init_done, hit, counts,
):
    """Stackless restart-trail traversal core (`TraversalKernel.h:28-146`),
    generic over the node storage via `fetch(node) -> (min_l, max_l, min_r,
    max_r, left, right, v0, v1, v2, prim)` (leaf interpretation rides the
    same fetch). Rays with `init_done` keep their given hit/counts; the
    64-bit trail/level words are emulated with (hi, lo) u32 pairs.
    """
    n_rays = rays.origin.shape[0]
    U32 = jnp.uint32

    def u64_shr1(hi, lo):
        return hi >> U32(1), (lo >> U32(1)) | ((hi & U32(1)) << U32(31))

    def u64_and(a, b):
        return a[0] & b[0], a[1] & b[1]

    def u64_or(a, b):
        return a[0] | b[0], a[1] | b[1]

    def u64_add(a, b):
        lo = a[1] + b[1]
        carry = (lo < a[1]).astype(U32)
        return a[0] + b[0] + carry, lo

    def u64_not(a):
        return ~a[0], ~a[1]

    def u64_neg(a):
        return u64_add(u64_not(a), (jnp.zeros_like(a[0]), jnp.ones_like(a[1])))

    def u64_sub(a, b):
        return u64_add(a, u64_neg(b))

    def u64_xor(a, b):
        return a[0] ^ b[0], a[1] ^ b[1]

    def u64_nonzero(a):
        return (a[0] | a[1]) != 0

    def u64_eq(a, b):
        return (a[0] == b[0]) & (a[1] == b[1])

    top_bit = (jnp.full(n_rays, 0x80000000, U32), jnp.zeros(n_rays, U32))
    zero64 = (jnp.zeros(n_rays, U32), jnp.zeros(n_rays, U32))
    one64 = (jnp.zeros(n_rays, U32), jnp.ones(n_rays, U32))

    node = jnp.zeros(n_rays, I32) + root
    trail = top_bit
    level = top_bit
    pop_level = zero64
    done = init_done

    def pop(level, pop_level, trail, node, active):
        """`pop` (`TraversalKernel.h:33-47`): climb the trail, restart from
        the root unless the trail is exhausted. Returns
        (level, pop_level, trail, node, exited)."""

        def sel64(pred, new, old):
            return (
                jnp.where(pred, new[0], old[0]),
                jnp.where(pred, new[1], old[1]),
            )

        trail_new = u64_add(u64_and(trail, u64_neg(level)), level)
        temp = u64_shr1(*trail_new)
        level_new = u64_add(u64_xor(u64_sub(temp, one64), temp), one64)
        exit_now = (trail_new[0] & U32(0x80000000)) == 0
        cont = active & ~exit_now

        trail_out = sel64(active, trail_new, trail)
        pop_level_out = sel64(cont, level_new, pop_level)
        level_out = sel64(cont, top_bit, sel64(active & exit_now, level_new, level))
        node_out = jnp.where(cont, jnp.zeros_like(node) + root, node)
        return level_out, pop_level_out, trail_out, node_out, active & exit_now

    def cond(c):
        return jnp.any(~c[0])

    def body(c):
        done, node, trail, level, pop_level, hit, counts = c
        active = ~done
        is_leaf = active & (node >= n_internal)
        minl, maxl, minr, maxr, l, r, rv0, rv1, rv2, prim = fetch(node)
        # --- leaf work
        v0 = A.transform_point(rv0, tr.scale, tr.quat, tr.translation)
        v1 = A.transform_point(rv1, tr.scale, tr.quat, tr.translation)
        v2 = A.transform_point(rv2, tr.scale, tr.quat, tr.translation)
        u, v, w, t = A.intersect_triangle(v0, v1, v2, rays.origin, rays.direction)
        good = is_leaf & (u > 0) & (v > 0) & (w > 0) & (t > 0) & (t < hit.t)
        hit = HitInfo(
            prim_idx=jnp.where(good, prim, hit.prim_idx),
            t=jnp.where(good, t, hit.t),
            u=jnp.where(good, u, hit.u),
            v=jnp.where(good, v, hit.v),
        )
        counts = counts + is_leaf.astype(jnp.uint32)

        # --- internal work
        is_int = active & ~is_leaf
        t0n, t0f = A.slab_intersect(minl, maxl, t_origin, t_inv_dir, hit.t)
        t1n, t1f = A.slab_intersect(minr, maxr, t_origin, t_inv_dir, hit.t)
        hit_l = t0n <= t0f
        hit_r = t1n <= t1f
        both = is_int & hit_l & hit_r
        one = is_int & (hit_l ^ hit_r)
        none = is_int & ~(hit_l | hit_r)

        near = jnp.where(t0n < t1n, l, r)
        far = jnp.where(t0n < t1n, r, l)

        # both-hit: level >>= 1; node = (trail & level) ? far : near
        level_b = u64_shr1(*level)
        take_far = u64_nonzero(u64_and(trail, level_b))
        node_b = jnp.where(take_far, far, near)

        # one-hit: level >>= 1; if level != popLevel: trail |= level, descend
        # else pop
        at_pop_level = u64_eq(level_b, pop_level)
        node_o = jnp.where(hit_r, r, l)
        trail_o = u64_or(trail, level_b)

        # apply both-hit
        level = (
            jnp.where(both | one, level_b[0], level[0]),
            jnp.where(both | one, level_b[1], level[1]),
        )
        node = jnp.where(both, node_b, node)
        descend_one = one & ~at_pop_level
        node = jnp.where(descend_one, node_o, node)
        trail = (
            jnp.where(descend_one, trail_o[0], trail[0]),
            jnp.where(descend_one, trail_o[1], trail[1]),
        )

        need_pop = is_leaf | none | (one & at_pop_level)
        level, pop_level, trail, node, exited = pop(
            level, pop_level, trail, node, need_pop
        )
        done = done | exited
        return done, node, trail, level, pop_level, hit, counts

    done, node, trail, level, pop_level, hit, counts = lax.while_loop(
        cond, body, (done, node, trail, level, pop_level, hit, counts)
    )
    return hit, counts
