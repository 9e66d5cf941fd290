"""Arbitrary-origin dense sweep traversal — the general-ray path.

The raster engine bakes a fixed eye into per-triangle Möller
coefficients, so it only serves pinhole frames. This engine drops that
restriction: the Plücker side products of a ray against a triangle's
edges are BILINEAR in (d, m = o x d), so every numerator of the
reference's triangle test (`intersectTriangle`,
`src/Common.h:516-531`) is a short dot product of
per-triangle coefficients with per-ray features (pos_i = v_i - o):

    u_num = (v0 x v2) . d + m . (v2 - v0)          (x2 dropped throughout)
    v_num = (v1 x v0) . d + m . (v0 - v1)
    w_num = (v2 x v1) . d + m . (v1 - v2)
    den   = n . d,           n = (v0 - v1) x (v2 - v0)
    t_num = n . v0 - n . o

The sweep writes these as broadcast float32 FMAs, like `raster._sweep`:

* rays are sorted once by (origin Morton cell | direction Morton cell)
  into coherent groups of 256; common-origin sets (`shadow_occlusion`'s
  reversed rays) degenerate to pure direction sorting — tight cones from
  the shared origin;
* group culling uses `raster._obox_vs_aabb` — the cone test generalized
  from a point eye to the group's origin box — and drops treelets beyond
  the group's farthest tmax; each group's candidates are sorted
  front-to-back by entry bound;
* a loop sweeps `chunk` candidate treelets of every group per step and
  keeps the closest in-range hit per ray.

This replaces the reference's per-thread while-while traversal
(`src/TraversalKernel.h:337-451`) for arbitrary ray sets
(shadow rays, AO, bounces). The stack-based wavefront engine
(`traverse.py`) is its oracle.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..types import HitInfo, Rays, Transformation, FLT_MAX
from . import aabb as A
from . import raster as R

I32 = jnp.int32
F32 = jnp.float32
BIG = jnp.float32(3.0e38)
RPG = 256  # rays per coherent group
NCOEF = 22  # per-prim coefficients: u, v, w (d 3 + m 3 each), n 3, n.v0


def _plucker_coefs(wt, prim_ids):
    """Per-prim Plücker coefficients f32[P, 22]: (cu_d, cu_m, cv_d, cv_m,
    cw_d, cw_m, n, n.v0) with padding prims zeroed (den = 0 never hits)."""
    v0, v1, v2 = wt[:, 0], wt[:, 1], wt[:, 2]
    n = jnp.cross(v0 - v1, v2 - v0)
    rows = jnp.concatenate(
        [
            jnp.cross(v0, v2), v2 - v0,
            jnp.cross(v1, v0), v0 - v1,
            jnp.cross(v2, v1), v1 - v2,
            n, jnp.sum(n * v0, axis=-1, keepdims=True),
        ],
        axis=1,
    )
    return rows * (prim_ids >= 0).astype(F32)[:, None]


def _sweep(o, d, m, tmin, tmax, c):
    """Closest in-range hit of rays (o, d, m f32[R, 3], tmin/tmax f32[R])
    against prims c f32[P, 22]. Returns (t f32[R] (BIG = miss), local prim
    i32[R], u f32[R], v f32[R])."""
    p = c.shape[0]

    def dot3(x, k):
        return (x[:, None, 0] * c[None, :, k] + x[:, None, 1] * c[None, :, k + 1]
                + x[:, None, 2] * c[None, :, k + 2])

    un = dot3(d, 0) + dot3(m, 3)
    vn = dot3(d, 6) + dot3(m, 9)
    wn = dot3(d, 12) + dot3(m, 15)
    den = dot3(d, 18)
    tn = c[None, :, 21] - dot3(o, 18)
    ok = jnp.minimum(
        jnp.minimum(un * den, vn * den), jnp.minimum(wn * den, tn * den)
    ) > 0
    safe = jnp.where(den != 0, den, 1.0)
    t = tn / safe
    t = jnp.where(ok & (t > tmin[:, None]) & (t < tmax[:, None]), t, BIG)
    tbest = jnp.min(t, axis=1)
    lp = jnp.arange(p, dtype=I32)[None, :]
    prim = jnp.min(jnp.where(t == tbest[:, None], lp, p), axis=1)
    best = lp == prim[:, None]  # exactly one column per ray
    inv = 1.0 / safe
    u = jnp.min(jnp.where(best, un * inv, BIG), axis=1)
    v = jnp.min(jnp.where(best, vn * inv, BIG), axis=1)
    return tbest, prim, u, v


def _morton15(x, y, z):
    """15-bit Morton interleave of 5-bit cell coords (plain u32 math)."""
    def spread(v):
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def _ray_sort_key(o, d, omin, oext):
    """Coherence key: origin Morton cell (15 bits, 32^3 cells) over
    direction Morton cell (15 bits over [-1,1]^3 — sign planes land on
    the top bit per axis, so octants separate first). Rays sharing a key
    traverse near-identical treelet sets. The direction minor bits make
    common-origin sets (a pinhole at a light — the reversed-shadow path)
    sort into tight cones."""
    q = jnp.clip(((o - omin[None, :]) / oext[None, :]) * 32.0, 0.0, 31.0)
    q = q.astype(jnp.uint32)
    qd = jnp.clip((d + 1.0) * 16.0, 0.0, 31.0).astype(jnp.uint32)
    return (_morton15(q[:, 0], q[:, 1], q[:, 2]) << 15) | _morton15(
        qd[:, 0], qd[:, 1], qd[:, 2]
    )


def trace_rays(
    scene: R.RasterScene,
    rays: Rays,
    tr: Transformation,
    cand_cap: int = 512,
    chunk: int = 4,
):
    """Closest-hit trace of an ARBITRARY ray set against a packed scene,
    honouring each ray's (tmin, tmax).

    Same results as `traverse.traverse_bvh2` (up to exact-t ties).
    Returns (HitInfo in input ray order, counts u32[R] = prims swept per
    ray, overflow bool[] — true when a ray group had more than `cand_cap`
    candidate treelets; the hits are then incomplete)."""
    return _trace_impl(
        scene.tris_sorted, scene.prim_ids, rays, tr,
        cand_cap, chunk, scene.leaf_size,
    )


@partial(jax.jit, static_argnames=("cand_cap", "chunk", "leaf_size"))
def _trace_impl(
    tris_sorted, prim_ids, rays: Rays, tr: Transformation,
    cand_cap: int, chunk: int, leaf_size: int,
):
    L = leaf_size
    R_in = rays.origin.shape[0]
    Rp = -(-R_in // RPG) * RPG
    ng = Rp // RPG

    wt = A.transform_point(tris_sorted, tr.scale, tr.quat, tr.translation)
    bmin, bmax = R._treelet_aabbs(wt, prim_ids, L)
    nt = bmin.shape[0]
    # translate scene AND origins by the scene centroid: Plücker moments
    # grow with |v|^2, so centering keeps the products accurate
    c0 = (jnp.min(bmin, axis=0) + jnp.max(bmax, axis=0)) * 0.5
    wt = wt - c0[None, None, :]
    bmin = bmin - c0[None, :]
    bmax = bmax - c0[None, :]

    o = rays.origin - c0[None, :]
    d = rays.direction
    tmin_r = rays.tmin
    tmax_r = rays.tmax
    if Rp != R_in:
        padn = Rp - R_in
        o = jnp.concatenate([o, jnp.zeros((padn, 3), F32)])
        d = jnp.concatenate([d, jnp.zeros((padn, 3), F32)])
        tmin_r = jnp.concatenate([tmin_r, jnp.zeros((padn,), F32)])
        # dead padding rays: tmax = -1 rejects every candidate t
        tmax_r = jnp.concatenate([tmax_r, jnp.full((padn,), -1.0, F32)])

    # ---- coherence sort: ONE ray permutation, as sort payload ----
    omin = jnp.min(o, axis=0)
    oext = jnp.maximum(jnp.max(o, axis=0) - omin, 1e-30)
    key = _ray_sort_key(o, d, omin, oext)
    rid = jnp.arange(Rp, dtype=I32)
    _, ox, oy, oz, dx, dy, dz, tmn, tmx, rids = lax.sort(
        (key, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
         tmin_r, tmax_r, rid),
        num_keys=1,
    )
    o_s = jnp.stack([ox, oy, oz], axis=-1).reshape(ng, RPG, 3)
    d_s = jnp.stack([dx, dy, dz], axis=-1).reshape(ng, RPG, 3)
    m_s = jnp.cross(o_s, d_s)
    tmn = tmn.reshape(ng, RPG)
    tmx = tmx.reshape(ng, RPG)

    # ---- per-group culling and front-to-back candidate lists ----
    possible, t_lb = R._obox_vs_aabb(
        jnp.min(o_s, axis=1)[:, None, :], jnp.max(o_s, axis=1)[:, None, :],
        jnp.min(d_s, axis=1)[:, None, :], jnp.max(d_s, axis=1)[:, None, :],
        bmin[None], bmax[None],
    )  # [ng, T]
    possible = possible & (t_lb <= jnp.max(tmx, axis=1)[:, None])
    tid = jnp.broadcast_to(jnp.arange(nt, dtype=I32)[None, :], possible.shape)
    _, tid_s = lax.sort((jnp.where(possible, t_lb, BIG), tid), num_keys=1)
    counts = jnp.sum(possible.astype(I32), axis=1)
    overflow = jnp.any(counts > cand_cap)
    cc = -(-min(cand_cap, nt) // chunk) * chunk
    if tid_s.shape[1] < cc:
        tid_s = jnp.concatenate(
            [tid_s, jnp.full((ng, cc - tid_s.shape[1]), nt, I32)], axis=1
        )
    live = jnp.minimum(counts, cc)
    cand = jnp.where(jnp.arange(cc, dtype=I32)[None, :] < live[:, None],
                     tid_s[:, :cc], nt)

    coefs = _plucker_coefs(wt, prim_ids).reshape(nt, L, NCOEF)
    coefs = jnp.concatenate([coefs, jnp.zeros((1, L, NCOEF), F32)])

    def group_step(o, d, m, tmin, tmax, ids):
        t, lp, u, v = _sweep(o, d, m, tmin, tmax, coefs[ids].reshape(-1, NCOEF))
        return t, ids[lp // L] * L + lp % L, u, v

    def step(k, best):
        ids = lax.dynamic_slice(cand, (0, k * chunk), (ng, chunk))
        new = jax.vmap(group_step)(o_s, d_s, m_s, tmn, tmx, ids)
        return R._combine(best, new)

    init = (
        jnp.full((ng, RPG), BIG),
        jnp.full((ng, RPG), -1, I32),
        jnp.zeros((ng, RPG), F32),
        jnp.zeros((ng, RPG), F32),
    )
    n_steps = -(-jnp.max(live) // chunk)
    t, prim, u, v = lax.fori_loop(0, n_steps, step, init)
    prim = jnp.where(t < BIG, prim, -1)
    swept = jnp.broadcast_to((live * L)[:, None], (ng, RPG))

    # ---- back to input ray order: rids is a permutation, so sorting by
    # it IS the inverse permutation ----
    _, t, prim, u, v, swept = lax.sort(
        (rids, t.reshape(-1), prim.reshape(-1), u.reshape(-1),
         v.reshape(-1), swept.reshape(-1)),
        num_keys=1,
        is_stable=False,
    )
    t, prim, u, v = t[:R_in], prim[:R_in], u[:R_in], v[:R_in]
    miss = prim < 0
    hit = HitInfo(
        prim_idx=jnp.where(miss, -1, prim_ids[jnp.maximum(prim, 0)]),
        t=jnp.where(miss, FLT_MAX, t),
        u=jnp.where(miss, 0.0, u),
        v=jnp.where(miss, 0.0, v),
    )
    return hit, swept[:R_in].astype(jnp.uint32), overflow


def shadow_occlusion(
    scene: R.RasterScene,
    points,
    live,
    light,
    tr: Transformation,
    eps: float,
    cand_cap: int = 512,
    chunk: int = 4,
):
    """Point-light occlusion for surface points — the reversed query.

    Traces light->point rays (instead of point->light) through the same
    sweep engine: a common origin collapses every group's origin box to a
    point, so `_obox_vs_aabb` degenerates to an exact cone test, and the
    direction-minor sort key groups rays into tight cones from the light.

    Occlusion is direction-symmetric: the reversed ray covers the same
    world segment [point + eps*l, light - eps*l] (l = unit point->light),
    so the boolean answer equals the forward query's.

    points: f32[N, 3] surface points (world space). live: bool[N] — dead
    entries (tmax = -1) are never occluded.
    light: f32[3]. eps: endpoint offset in world units.
    Returns (occluded bool[N], counts u32[N], overflow bool[]).
    """
    n = points.shape[0]
    dvec = points - light[None, :]
    dist = jnp.linalg.norm(dvec, axis=1)
    d = dvec / jnp.maximum(dist, 1e-9)[:, None]
    rays = Rays(
        origin=jnp.broadcast_to(light, (n, 3)),
        direction=d,
        tmin=jnp.full((n,), eps, F32),
        tmax=jnp.where(live, dist - eps, -1.0),
    )
    hit, counts, overflow = trace_rays(scene, rays, tr, cand_cap, chunk)
    return (hit.prim_idx >= 0) & live, counts, overflow
