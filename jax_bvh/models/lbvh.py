"""LBVH builders (two-pass Karras and single-pass Apetrei-equivalent).

Re-expressions of the reference pipelines
`src/TwoPassLbvh.cpp:17-196` and
`src/SinglePassLbvh.cpp:17-183`: one pure jitted function per
builder — upload/readback, per-phase kernel compiles, and mid-build host
validation round-trips all disappear; validation runs jit-external on the
returned arrays (see jax_bvh.utils.validate).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import aabb as A
from ..ops import extents, morton, radix_tree, sort
from ..types import Bvh2, PrimRefs

I32 = jnp.int32


def prim_refs_from_triangles(tris) -> PrimRefs:
    """Identity PrimRef generation (1 ref per triangle) — the reference's
    default early-split-clipping path with saMax=FltMax
    (`TwoPassLbvh.cpp:22-32`, `Utility.cpp:456-538`)."""
    mn, mx = A.triangle_aabbs(tris)
    n = tris.shape[0]
    return PrimRefs(aabb_min=mn, aabb_max=mx, prim_idx=jnp.arange(n, dtype=I32))


def _sorted_leaf_order(refs: PrimRefs, use_extended: bool):
    """extents -> Morton codes -> sort: the shared front half of every
    builder (`TwoPassLbvh.cpp:35-89`)."""
    scene_min, scene_max = extents.scene_extents(refs.aabb_min, refs.aabb_max)
    ext = scene_max - scene_min
    centroids = A.center(refs.aabb_min, refs.aabb_max)
    norm = morton.normalize_centroids(centroids, scene_min, ext)
    if use_extended:
        codes = morton.extended_morton30(norm, ext)
    else:
        codes = morton.morton30(norm)
    order = jnp.arange(refs.prim_idx.shape[0], dtype=I32)
    sorted_codes, sorted_pos = sort.sort_pairs(codes, order)
    return sorted_codes, sorted_pos


def _sorted_leaves(refs: PrimRefs, use_extended: bool):
    """Like `_sorted_leaf_order`, but the leaf AABBs and prim ids ride the
    sort as payload operands instead of a permutation gather afterwards.

    Works column-major internally: the six AABB columns come from one
    [6, n] transpose instead of six slices."""
    codes, packed_t, leaf_prim = _sorted_leaves_packed(refs, use_extended)
    return (
        codes,
        packed_t[0:3].T,
        -packed_t[3:6].T,
        leaf_prim,
    )


def _sorted_leaves_packed(refs: PrimRefs, use_extended: bool):
    cols = refs.aabb_min.T  # [3, n] — one relayout
    cols_max = refs.aabb_max.T
    return _sorted_leaves_cols(
        cols[0], cols[1], cols[2],
        cols_max[0], cols_max[1], cols_max[2],
        refs.prim_idx, use_extended,
    )


def _sorted_leaves_cols(mnx, mny, mnz, mxx, mxy, mxz, prim_idx, use_extended):
    """Returns (sorted_codes, leaf_packed_t f32[6, n] with rows
    (min xyz, -max xyz) in sorted order, leaf_prim i32[n]) — the lane-major
    packed layout the whole build pipeline carries."""
    scene_min = jnp.stack([jnp.min(mnx), jnp.min(mny), jnp.min(mnz)])
    scene_max = jnp.stack([jnp.max(mxx), jnp.max(mxy), jnp.max(mxz)])
    ext = scene_max - scene_min
    safe = jnp.where(ext > 0, ext, 1.0)
    nx = ((mnx + mxx) * 0.5 - scene_min[0]) / safe[0]
    ny = ((mny + mxy) * 0.5 - scene_min[1]) / safe[1]
    nz = ((mnz + mxz) * 0.5 - scene_min[2]) / safe[2]
    if use_extended:
        codes = morton.extended_morton30_cols(nx, ny, nz, ext)
    else:
        codes = morton.morton30_cols(nx, ny, nz)
    # total-order sort on (code, prim_idx): prim_idx is the ORIGINAL
    # index, so this reproduces the stable-by-code order byte-for-byte
    # (the canonical leaf order every distributed reimplementation is
    # tested bit-identical against) while running lax.sort unstable
    # (see ops/sort.py)
    ops = (codes, prim_idx, mnx, mny, mnz, -mxx, -mxy, -mxz)
    out = jax.lax.sort(ops, num_keys=2, is_stable=False)
    sorted_codes = out[0]
    leaf_packed_t = jnp.stack(out[2:8], axis=0)  # [6, n] major-dim stack
    leaf_prim = out[1]
    return sorted_codes, leaf_packed_t, leaf_prim


def _finalize(leaf_min, leaf_max, leaf_prim, left, right, int_min, int_max, root):
    """Fill the node SoA: leaves in sorted order (leaf slot n-1+i holds the
    i-th sorted PrimRef, `TwoPassLbvhKernel.h:164-194`)."""
    n = leaf_prim.shape[0]
    node_min = jnp.concatenate([int_min, leaf_min], axis=0)
    node_max = jnp.concatenate([int_max, leaf_max], axis=0)
    left = left.at[n - 1 :].set(leaf_prim)
    return Bvh2.from_rows(node_min, node_max, left, right, root)


def _finalize_packed(leaf_packed_t, leaf_prim, left, right, int_packed_t, root):
    """Packed finalize: ONE lane-major concat — Bvh2 stores the packed
    layout natively, so no relayout happens at all."""
    n = leaf_prim.shape[0]
    node_packed = jnp.concatenate([int_packed_t, leaf_packed_t], axis=1)
    left = left.at[n - 1 :].set(leaf_prim)
    return Bvh2(packed_t=node_packed, left=left, right=right, root=root)


def _sorted_leaves_from_tris(tris, use_extended: bool):
    """Triangle-soup front end in pure column form: one [n,9] transpose
    feeds per-axis AABB mins/maxes (no [n,3] minor-dim ops at all).
    Returns the packed contract of `_sorted_leaves_cols`."""
    n = tris.shape[0]
    t9 = tris.reshape(n, 9).T  # [9, n]: v0x v0y v0z v1x ... v2z
    mnx = jnp.minimum(jnp.minimum(t9[0], t9[3]), t9[6])
    mny = jnp.minimum(jnp.minimum(t9[1], t9[4]), t9[7])
    mnz = jnp.minimum(jnp.minimum(t9[2], t9[5]), t9[8])
    mxx = jnp.maximum(jnp.maximum(t9[0], t9[3]), t9[6])
    mxy = jnp.maximum(jnp.maximum(t9[1], t9[4]), t9[7])
    mxz = jnp.maximum(jnp.maximum(t9[2], t9[5]), t9[8])
    return _sorted_leaves_cols(
        mnx, mny, mnz, mxx, mxy, mxz, jnp.arange(n, dtype=I32), use_extended
    )


@partial(jax.jit, static_argnames=("use_extended",))
def build_two_pass(tris, use_extended: bool = True) -> Bvh2:
    """Karras two-pass LBVH (`TwoPassLbvh.cpp:17-152`). Root is node 0."""
    codes, leaf_packed_t, leaf_prim = _sorted_leaves_from_tris(
        tris, use_extended
    )
    left, right, int_packed_t = radix_tree.karras_build_packed(
        codes, leaf_packed_t
    )
    return _finalize_packed(
        leaf_packed_t, leaf_prim, left, right, int_packed_t,
        jnp.zeros((), I32),
    )


@partial(jax.jit, static_argnames=("use_extended",))
def build_two_pass_refs(refs: PrimRefs, use_extended: bool = True) -> Bvh2:
    codes, leaf_packed_t, leaf_prim = _sorted_leaves_packed(refs, use_extended)
    left, right, int_packed_t = radix_tree.karras_build_packed(
        codes, leaf_packed_t
    )
    return _finalize_packed(
        leaf_packed_t, leaf_prim, left, right, int_packed_t,
        jnp.zeros((), I32),
    )


@partial(jax.jit, static_argnames=("use_extended",))
def build_single_pass(tris, use_extended: bool = True) -> Bvh2:
    """Apetrei-style single-pass LBVH (`SinglePassLbvh.cpp:17-183`) — same
    tree, split-position node layout, root index data-dependent (the
    reference reads it back from `bvhNodeCounter[n-1]`,
    `SinglePassLbvh.cpp:131`; here it's a traced scalar)."""
    codes, leaf_packed_t, leaf_prim = _sorted_leaves_from_tris(
        tris, use_extended
    )
    left, right, _parent, int_packed_t, root = radix_tree.apetrei_build_packed(
        codes, leaf_packed_t
    )
    return _finalize_packed(leaf_packed_t, leaf_prim, left, right, int_packed_t, root)


@partial(jax.jit, static_argnames=("use_extended",))
def build_single_pass_refs(refs: PrimRefs, use_extended: bool = True) -> Bvh2:
    codes, leaf_packed_t, leaf_prim = _sorted_leaves_packed(refs, use_extended)
    left, right, _parent, int_packed_t, root = radix_tree.apetrei_build_packed(
        codes, leaf_packed_t
    )
    return _finalize_packed(leaf_packed_t, leaf_prim, left, right, int_packed_t, root)
