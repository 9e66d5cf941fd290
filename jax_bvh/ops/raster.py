"""Tile-binned raster traversal — the primary-ray renderer.

The reference renders by per-thread BVH descent (`TraversalKernel.h:28-451`).
This engine restructures closest-hit rendering of a pinhole frame into
dense per-tile sweeps:

* the Morton-sorted leaves are chopped into fixed **treelets** of L prims
  (contiguous slabs — Morton-chunk clusters, i.e. a 2-level BVH);
* rays are grouped into screen **tiles**; a dense `[tiles, treelets]`
  direction-interval cone test (exact conservative culling on the *actual*
  per-tile direction bounds, so the reference's `normalize(eye + dir*far)`
  ray quirk costs nothing) produces per-tile candidate treelet lists,
  compacted by cumsums — no per-ray sorting anywhere;
* candidates are ordered front-to-back by treelet eye-distance;
* each (tile, treelet-group) does a dense ray-vs-prim sweep. For a pinhole
  frame all origins coincide, so Möller's numerators/denominator are LINEAR
  in the ray direction: per prim four 3-vectors (cu, cv, cw, cden) and a
  scalar t0 turn the whole [rays x prims] test into broadcast FMAs plus
  elementwise sign checks — the hit condition `u>0 & v>0 & w>0 & t>0` of
  `TraversalKernel.h:86-91` evaluated as `min(u*den, v*den, w*den, t0*den) > 0`.

Same closest hits as `traverse.traverse_bvh2` (same triangle formula,
`Common.h:516-531`), different schedule. `render_raster_xla` is the plain
reference; on a GPU `render_raster` runs the Triton kernel in
`raster_triton.py`, which skips occluded treelets instead of sweeping them.
The wavefront engine remains the general path for arbitrary-origin rays.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..types import Bvh2, HitInfo, Rays, Transformation, FLT_MAX
from . import aabb as A

I32 = jnp.int32
F32 = jnp.float32
BIG = jnp.float32(3.0e38)


class RasterScene(NamedTuple):
    """Per-scene packing: Morton-sorted triangles in object space, chopped
    into treelets of `leaf_size` prims (slab t holds rows [t*L, (t+1)*L))."""

    tris_sorted: jax.Array  # f32[T*L, 3, 3] object space (padded, degenerate)
    prim_ids: jax.Array  # i32[T*L] original prim index (-1 = padding)
    n_real: int  # real prim count
    leaf_size: int


def pack_raster(bvh: Bvh2, tris, leaf_size: int = 64) -> RasterScene:
    """One-time scene packing from a built BVH2: gathers triangles into
    Morton-sorted leaf order (the only gather in the engine, amortized over
    all frames) and pads to a whole number of treelets."""
    n = bvh.n_leaves
    prim = bvh.left[bvh.n_internal :]
    ts = tris[jnp.clip(prim, 0, tris.shape[0] - 1)]
    return pack_raster_sorted(ts, prim, leaf_size)


def pack_raster_sorted(tris_sorted, prim_ids, leaf_size: int = 64) -> RasterScene:
    """Packing straight from sorted-leaf products (no gather at all — the
    triangle columns can ride the Morton sort as payload)."""
    n = tris_sorted.shape[0]
    pad = (-n) % leaf_size
    if pad:
        tris_sorted = jnp.concatenate(
            [tris_sorted, jnp.zeros((pad, 3, 3), F32)], axis=0
        )
        prim_ids = jnp.concatenate([prim_ids, jnp.full((pad,), -1, I32)])
    return RasterScene(
        tris_sorted=tris_sorted, prim_ids=prim_ids, n_real=n, leaf_size=leaf_size
    )


def _treelet_aabbs(world_tris, prim_ids, leaf_size: int):
    """Treelet AABBs by dense segmented reduce (padding rows stay empty)."""
    nt = world_tris.shape[0] // leaf_size
    v = world_tris.reshape(nt, leaf_size, 3, 3)
    real = (prim_ids >= 0).reshape(nt, leaf_size, 1, 1)
    mn = jnp.min(jnp.where(real, v, BIG), axis=(1, 2))
    mx = jnp.max(jnp.where(real, v, -BIG), axis=(1, 2))
    return mn, mx


def _moller_coefs(world_tris, eye):
    """Fixed-origin Möller coefficients. For origin e and direction d:

      u_num = ((v0+v2-2e) x (v2-v0)) . d        (edge0 = v2-v0)
      v_num = ((v1+v0-2e) x (v0-v1)) . d        (edge1 = v0-v1)
      w_num = ((v2+v1-2e) x (v1-v2)) . d        (edge2 = v1-v2)
      den   = 2 * ((v0-v1) x (v2-v0)) . d
      t_num = 2 * (v0 - e) . normal             (constant per prim)

    and u = u_num/den etc — algebraically identical to
    `A.intersect_triangle` / `Common.h:516-531` with pos_i = v_i - e folded
    into per-prim vectors. Returns (coefs f32[P, 4, 3] rows
    (cu, cv, cw, cden), t0 f32[P])."""
    v0, v1, v2 = world_tris[:, 0], world_tris[:, 1], world_tris[:, 2]
    edge0 = v2 - v0
    edge1 = v0 - v1
    normal = jnp.cross(edge1, edge0)
    edge2 = v1 - v2
    cu = jnp.cross(v0 + v2 - 2.0 * eye, edge0)
    cv = jnp.cross(v1 + v0 - 2.0 * eye, edge1)
    cw = jnp.cross(v2 + v1 - 2.0 * eye, edge2)
    cden = 2.0 * normal
    t0 = 2.0 * jnp.sum((v0 - eye) * normal, axis=-1)
    return jnp.stack([cu, cv, cw, cden], axis=1), t0


def tile_order(width: int, height: int, tile: int):
    """Permutation p with dirs_tile_major = dirs_xmajor[p] for the
    reference's flat ray layout (index = x*height + y,
    `CommonBlocksKernel.h:458`)."""
    assert width % tile == 0 and height % tile == 0
    x = jnp.arange(width)
    y = jnp.arange(height)
    gx, gy = jnp.meshgrid(x, y, indexing="ij")
    flat = (gx * height + gy).reshape(width, height)
    t = flat.reshape(width // tile, tile, height // tile, tile)
    t = t.transpose(0, 2, 1, 3)
    return t.reshape(-1)


def pad_frame(rays: Rays, width: int, height: int, edge: int):
    """Pad a pinhole frame to multiples of `edge` pixels with
    edge-replicated rays. Returns (rays, padded width, padded height, crop)
    where `crop` maps a padded per-ray array back to width x height."""
    wp = -(-width // edge) * edge
    hp = -(-height // edge) * edge
    d = rays.direction.reshape(width, height, 3)
    d = jnp.pad(d, ((0, wp - width), (0, hp - height), (0, 0)), mode="edge")
    padded = Rays(
        origin=jnp.broadcast_to(rays.origin[0], (wp * hp, 3)),
        direction=d.reshape(wp * hp, 3),
        tmin=jnp.zeros((wp * hp,), F32),
        tmax=jnp.full((wp * hp,), FLT_MAX, F32),
    )

    def crop(x):
        return x.reshape(wp, hp)[:width, :height].reshape(-1)

    return padded, wp, hp, crop


def _cone_vs_aabb(eye, dmin, dmax, bmin, bmax):
    """Conservative test: can ANY ray from `eye` with direction in the box
    [dmin, dmax] (componentwise) hit AABB [bmin, bmax]?

    Per axis the reachable coordinate interval at parameter t>=0 is
    [e + t*dmin, e + t*dmax]; overlap with the slab gives a t-interval, and
    axes intersect. Over-estimates (axes treated independently) but never
    misses. Returns (possible bool[...], t_lower f32[...]).

    Shapes broadcast; last axis is xyz.
    """
    return _interval_cull(bmin - eye, bmax - eye, dmin, dmax)


def _obox_vs_aabb(omin, omax, dmin, dmax, bmin, bmax):
    """`_cone_vs_aabb` generalized to an origin BOX [omin, omax]: can any
    ray with origin in the box and direction in [dmin, dmax] hit the AABB?
    Per axis the t>=0 reachable interval is
    [omin + t*dmin, omax + t*dmax] — the same slab-interval logic with the
    gap measured from the nearest origin face. Used by the general-ray
    sweep engine (`ray_sweep.py`), where rays do not share an eye."""
    return _interval_cull(bmin - omax, bmax - omin, dmin, dmax)


def _interval_cull(a, b, dmin, dmax):
    """Shared core: exists t >= 0 with t*dmax >= a and t*dmin <= b per
    axis, intersected over axes. Returns (possible, t_lower)."""

    # t*dmax >= a: dmax>0 -> t >= a/dmax (if a>0) else all t;
    #              dmax<=0 -> all t if a<=0, else empty... except dmax<0 &
    #              a<=0 additionally caps t <= a/dmax.
    lo1 = jnp.where((dmax > 0) & (a > 0), a / jnp.where(dmax > 0, dmax, 1.0), 0.0)
    hi1 = jnp.where((dmax < 0) & (a <= 0), a / jnp.where(dmax < 0, dmax, 1.0), BIG)
    empty1 = (dmax <= 0) & (a > 0)

    # t*dmin <= b: dmin>0 -> t <= b/dmin (empty if b<0);
    #              dmin<=0 -> all t if b>=0, else t >= b/dmin.
    hi2 = jnp.where(dmin > 0, b / jnp.where(dmin > 0, dmin, 1.0), BIG)
    lo2 = jnp.where((dmin < 0) & (b < 0), b / jnp.where(dmin < 0, dmin, 1.0), 0.0)
    empty2 = (dmin >= 0) & (b < 0)

    lo = jnp.max(jnp.maximum(lo1, lo2), axis=-1)
    hi = jnp.min(jnp.minimum(hi1, hi2), axis=-1)
    empty = jnp.any(empty1 | empty2, axis=-1)
    possible = (~empty) & (lo <= hi)
    return possible, jnp.where(possible, lo, BIG)


class RasterBins(NamedTuple):
    """Per-frame binning: for each tile, up to `cap` candidate treelets in
    front-to-back (eye-distance) order, padded with -1."""

    cand: jax.Array  # i32[tiles, cap] treelet ids, -1 padding
    t_lb: jax.Array  # f32[tiles, cap] conservative entry-t lower bound
    counts: jax.Array  # i32[tiles]
    overflow: jax.Array  # bool[]


def bin_treelets(
    eye, dirs_tile_major, bmin, bmax, n_tiles: int, rays_per_tile: int, cap: int
) -> RasterBins:
    """Dense cone-vs-AABB culling + cumsum compaction (the only sort is a
    tiny [T] eye-distance argsort for front-to-back order)."""
    d = dirs_tile_major.reshape(n_tiles, rays_per_tile, 3)
    dmin = jnp.min(d, axis=1)
    dmax = jnp.max(d, axis=1)

    center = (bmin + bmax) * 0.5
    dist = jnp.sum((center - eye) ** 2, axis=-1)
    order = jnp.argsort(dist).astype(I32)
    bmin_o = bmin[order]
    bmax_o = bmax[order]

    possible, t_lb = _cone_vs_aabb(
        eye, dmin[:, None, :], dmax[:, None, :], bmin_o[None], bmax_o[None]
    )  # [tiles, T]

    pos = jnp.cumsum(possible.astype(I32), axis=1)
    counts = pos[:, -1]
    slot = jnp.where(possible, pos - 1, cap)
    slot = jnp.minimum(slot, cap)
    tile_ids = jnp.arange(n_tiles, dtype=I32)[:, None]
    cand = jnp.full((n_tiles, cap + 1), -1, I32)
    cand = cand.at[tile_ids, slot].set(
        jnp.broadcast_to(order[None, :], possible.shape), mode="drop"
    )
    tlb = jnp.full((n_tiles, cap + 1), BIG, F32)
    tlb = tlb.at[tile_ids, slot].set(t_lb, mode="drop")
    return RasterBins(
        cand=cand[:, :cap],
        t_lb=tlb[:, :cap],
        counts=counts,
        overflow=jnp.any(counts > cap),
    )


def _sweep(dirs, coefs, t0):
    """Dense ray-vs-prim-slab sweep. dirs f32[R, 3], coefs f32[P, 4, 3],
    t0 f32[P] (0 ⇒ never hits). Returns per-ray best-in-slab
    (t f32[R] (BIG = miss), local prim i32[R], u f32[R], v f32[R]).

    Written as explicit broadcast FMAs (K=3 contraction) rather than a
    matmul so that under vmap XLA fuses the whole sweep; a batched matmul
    would materialize [tiles, R, 4P]."""
    p = coefs.shape[0]
    d = dirs[:, None, :]  # [R, 1, 3]
    c = coefs.reshape(1, p * 4, 3)
    planes = d[..., 0] * c[..., 0] + d[..., 1] * c[..., 1] + d[..., 2] * c[..., 2]
    planes = planes.reshape(dirs.shape[0], p, 4)
    un, vn, wn, den = (
        planes[..., 0],
        planes[..., 1],
        planes[..., 2],
        planes[..., 3],
    )
    tn = t0[None, :]
    valid = (
        jnp.minimum(
            jnp.minimum(un * den, vn * den), jnp.minimum(wn * den, tn * den)
        )
        > 0
    )
    safe_den = jnp.where(den != 0, den, 1.0)
    t = jnp.where(valid, tn / safe_den, BIG)
    tmin = jnp.min(t, axis=1)
    lp = jnp.arange(p, dtype=I32)[None, :]
    prim = jnp.min(jnp.where(t == tmin[:, None], lp, p), axis=1)
    best = lp == prim[:, None]  # exactly one column per ray
    inv = 1.0 / safe_den
    u = jnp.min(jnp.where(best, un * inv, BIG), axis=1)
    v = jnp.min(jnp.where(best, vn * inv, BIG), axis=1)
    return tmin, prim, u, v


def render_raster_xla(
    scene: RasterScene,
    rays: Rays,
    tr: Transformation,
    width: int,
    height: int,
    tile: int = 16,
    cap_a: int = 16,
    cap_b: int = 256,
    tiles_b: int = 64,
):
    """Raster render, pure XLA.

    Two-pass schedule: pass A sweeps the first `cap_a` candidate treelets of
    EVERY tile (dense, the common case); the rare tiles with more candidates
    are compacted and their remaining slots [cap_a, cap_b) swept in pass B
    (`tiles_b` tile slots), entered only when needed via lax.cond.

    Returns (HitInfo in the reference's x-major ray order,
    counts u32[R] = prims swept per ray, overflow bool[] — true when a tile
    exceeded cap_b candidates or more than tiles_b tiles overflowed pass A;
    callers should size caps so this never fires).
    """
    return _render_xla_impl(
        scene.tris_sorted,
        scene.prim_ids,
        rays,
        tr,
        width,
        height,
        tile,
        cap_a,
        cap_b,
        tiles_b,
        scene.leaf_size,
    )


def _combine(acc, new):
    """Closest-hit merge of two (t, prim, u, v) tuples."""
    better = new[0] < acc[0]
    return tuple(jnp.where(better, n, a) for n, a in zip(new, acc))


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "tile", "cap_a", "cap_b", "tiles_b", "leaf_size"
    ),
)
def _render_xla_impl(
    tris_sorted,
    prim_ids,
    rays: Rays,
    tr: Transformation,
    width: int,
    height: int,
    tile: int,
    cap_a: int,
    cap_b: int,
    tiles_b: int,
    leaf_size: int,
):
    L = leaf_size
    if width % tile or height % tile:
        rp, wp, hp, crop = pad_frame(rays, width, height, tile)
        hit, counts, overflow = _render_xla_impl(
            tris_sorted, prim_ids, rp, tr, wp, hp, tile, cap_a, cap_b,
            tiles_b, leaf_size,
        )
        return HitInfo(*(crop(f) for f in hit)), crop(counts), overflow
    n_rays = width * height
    rpt = tile * tile
    n_tiles = n_rays // rpt
    perm = tile_order(width, height, tile)

    wt = A.transform_point(tris_sorted, tr.scale, tr.quat, tr.translation)
    bmin, bmax = _treelet_aabbs(wt, prim_ids, L)
    eye = rays.origin[0]
    coefs, t0 = _moller_coefs(wt, eye)
    # padding prims: t0 = 0 makes `t0*den > 0` false — never hit
    t0 = jnp.where(prim_ids >= 0, t0, 0.0)
    nt = bmin.shape[0]
    coefs_t = coefs.reshape(nt, L, 4, 3)
    t0_t = t0.reshape(nt, L)

    dirs_tm = rays.direction[perm].reshape(n_tiles, rpt, 3)
    bins = bin_treelets(
        eye, dirs_tm.reshape(-1, 3), bmin, bmax, n_tiles, rpt, cap_b
    )

    def sweep_slots(d, ids):
        """Sweep `ids` (i32[k], -1 padded) treelet slabs for one tile's
        rays d f32[rpt, 3]. Returns (t, global sorted-leaf prim, u, v)."""
        k = ids.shape[0]
        sid = jnp.clip(ids, 0, nt - 1)
        c = coefs_t[sid].reshape(k * L, 4, 3)
        tt = jnp.where((ids >= 0)[:, None], t0_t[sid], 0.0).reshape(k * L)
        t2, lp, u2, v2 = _sweep(d, c, tt)
        lp = jnp.clip(lp, 0, k * L - 1)
        gprim = sid[lp // L] * L + (lp % L)
        gprim = jnp.where(t2 < BIG, gprim, -1)
        return t2, gprim, u2, v2

    # ---- pass A: first cap_a candidates of every tile
    t, prim, u, v = jax.vmap(sweep_slots)(dirs_tm, bins.cand[:, :cap_a])

    # ---- pass B: overflow tiles sweep slots [cap_a, cap_b)
    over = bins.counts > cap_a
    n_over = jnp.sum(over.astype(I32))

    def pass_b(args):
        t, prim, u, v = args
        opos = jnp.cumsum(over.astype(I32)) - 1
        slot = jnp.where(over, jnp.minimum(opos, tiles_b - 1), tiles_b)
        tsel = jnp.full((tiles_b + 1,), n_tiles, I32)
        tsel = tsel.at[slot].set(jnp.arange(n_tiles, dtype=I32), mode="drop")
        tsel = tsel[:tiles_b]
        tclip = jnp.minimum(tsel, n_tiles - 1)
        d_b = dirs_tm[tclip]
        ids_b = jnp.where(
            (tsel < n_tiles)[:, None], bins.cand[tclip, cap_a:], -1
        )
        tb, pb, ub, vb = jax.vmap(sweep_slots)(d_b, ids_b)
        # scatter back to tile-major and merge
        t2 = jnp.full_like(t, BIG).at[tclip].set(tb, mode="drop")
        p2 = jnp.full_like(prim, -1).at[tclip].set(pb, mode="drop")
        u2 = jnp.zeros_like(u).at[tclip].set(ub, mode="drop")
        v2 = jnp.zeros_like(v).at[tclip].set(vb, mode="drop")
        return _combine((t, prim, u, v), (t2, p2, u2, v2))

    t, prim, u, v = lax.cond(
        n_over > 0, pass_b, lambda a: a, (t, prim, u, v)
    )

    counts = (jnp.minimum(bins.counts, cap_b) * L).astype(jnp.uint32)
    counts = jnp.broadcast_to(counts[:, None], (n_tiles, rpt)).reshape(-1)

    t = t.reshape(-1)
    prim_sorted = prim.reshape(-1)
    u = u.reshape(-1)
    v = v.reshape(-1)

    miss = prim_sorted < 0
    safe = jnp.clip(prim_sorted, 0, prim_ids.shape[0] - 1)
    prim_orig = jnp.where(miss, -1, prim_ids[safe])

    inv = jnp.zeros((n_rays,), I32).at[perm].set(jnp.arange(n_rays, dtype=I32))
    hit = HitInfo(
        prim_idx=prim_orig[inv],
        t=jnp.where(miss, FLT_MAX, t)[inv],
        u=jnp.where(miss, 0.0, u)[inv],
        v=jnp.where(miss, 0.0, v)[inv],
    )
    overflow = bins.overflow | (n_over > tiles_b)
    return hit, counts[inv], overflow


def raster_engine() -> str:
    """The engine `render_raster` runs on the default backend: "triton"
    (the kernel) on a GPU, "xla" (the plain reference) on the CPU."""
    backend = jax.default_backend()
    if backend == "gpu":
        return "triton"
    if backend == "cpu":
        return "xla"
    raise RuntimeError(f"no raster engine for backend {backend!r}")


def render_raster(scene: RasterScene, rays: Rays, tr: Transformation,
                  width: int, height: int):
    """Primary-ray render with the engine `raster_engine()` names.
    Returns (HitInfo in x-major ray order, counts u32[R], overflow bool[])."""
    if raster_engine() == "triton":
        from .raster_triton import render_raster_triton

        return render_raster_triton(scene, rays, tr, width, height)
    return render_raster_xla(scene, rays, tr, width, height)
