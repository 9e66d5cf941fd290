"""Primary-ray raster sweep as a Pallas kernel through Triton (Hopper).

Same algorithm and results as `raster.render_raster_xla` (tile-binned
ray-vs-prim sweeps with fixed-origin Möller coefficients), scheduled so
that occluded work is skipped instead of computed and discarded:

* **Coarse binning** in XLA: the image is cut into 64x64-pixel coarse
  tiles; a dense [CT, T] cone test against the treelet AABBs and one
  per-row sort by conservative entry-t give every coarse tile a
  front-to-back candidate list (`cand`, `tlb`, `cnt`).
* **Fine culling bits** in XLA: each candidate carries a 16-bit mask of
  the 16x16-pixel subtiles whose direction cone can reach it.
* **One program per (coarse tile, subtile)**: 256 rays stay in registers
  with their best (t, prim, u, v). A loop walks the tile's candidates in
  order and sweeps a treelet only when the subtile's bit is set and the
  candidate's entry bound is below the subtile's worst closest-t so far.
  The sweep is float32 FMAs on the CUDA cores: the contraction depth is 3,
  below the smallest tensor-core MMA depth, and TF32 would move the
  closest-hit t. Programs share nothing, so block order does not matter.

The kernel writes the sorted-leaf index of the winner; the original prim
id is looked up in XLA afterwards.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..types import FLT_MAX, HitInfo, Rays, Transformation
from . import aabb as A
from . import raster as R

I32 = jnp.int32
F32 = jnp.float32
BIG = jnp.float32(3.0e38)
BIGF = 3.0e38  # python literal: safe to close over inside the kernel
SUB = 16  # subtile edge in pixels
CGRID = 4  # subtiles per coarse tile edge (coarse tile = 64x64 px)
RPT = SUB * SUB  # rays per subtile = rays per program
RPC = RPT * CGRID * CGRID  # rays per coarse tile (4096)
NSUB = CGRID * CGRID  # 16
NCOEF = 16  # coefficient rows per treelet: cu, cv, cw, cden (xyz), t0, pad
LANES = 16  # prims swept per inner step (bounds the live [LANES, RPT] tiles)


def _to_coarse_layout(arr_wh, W: int, H: int):
    """[W, H, C] x-major -> [CT, 4096, C] in (coarse, subtile, within)
    order; subtile s of a coarse tile holds rays [s*256, (s+1)*256)."""
    cw, ch = W // (SUB * CGRID), H // (SUB * CGRID)
    t = arr_wh.reshape(cw, CGRID, SUB, ch, CGRID, SUB, -1)
    t = t.transpose(0, 3, 1, 4, 2, 5, 6)  # [cw, ch, sx, sy, wx, wy, C]
    return t.reshape(cw * ch, RPC, -1)


def _from_coarse_layout(arr_ct, W: int, H: int):
    """Inverse of `_to_coarse_layout` for [CT, 4096, C] arrays."""
    cw, ch = W // (SUB * CGRID), H // (SUB * CGRID)
    t = arr_ct.reshape(cw, ch, CGRID, CGRID, SUB, SUB, -1)
    t = t.transpose(0, 2, 4, 1, 3, 5, 6)
    return t.reshape(W * H, -1)


def _coef_table(wt, prim_ids, eye, leaf_size: int):
    """Per-treelet Möller coefficients f32[T+1, 16, L]: rows 0-11 are
    (cu, cv, cw, cden) xyz, row 12 is t0, rows 13-15 pad. Padding prims
    and the all-zero treelet T have t0 = 0, so `t0*den > 0` never holds."""
    L = leaf_size
    coefs, t0 = R._moller_coefs(wt, eye)  # [P, 4, 3], [P]
    t0 = jnp.where(prim_ids >= 0, t0, 0.0)
    nt = wt.shape[0] // L
    rows = jnp.concatenate(
        [coefs.reshape(-1, 12), t0[:, None], jnp.zeros((t0.shape[0], 3), F32)],
        axis=1,
    )  # [P, 16]
    table = rows.reshape(nt, L, NCOEF).transpose(0, 2, 1)
    return jnp.concatenate([table, jnp.zeros((1, NCOEF, L), F32)], axis=0)


def _kernel(dirs_ref, cand_ref, tlb_ref, bits_ref, cnt_ref, coef_ref,
            t_ref, p_ref, u_ref, v_ref, c_ref):
    from jax.experimental import pallas as pl

    ct = pl.program_id(0)
    s = pl.program_id(1)
    L = coef_ref.shape[2]
    lc = min(LANES, L)
    rays = pl.ds(pl.multiple_of((ct * NSUB + s) * RPT, RPT), RPT)
    dx = dirs_ref[0, rays][None, :]
    dy = dirs_ref[1, rays][None, :]
    dz = dirs_ref[2, rays][None, :]
    lane = lax.broadcasted_iota(I32, (lc, RPT), 0)

    def sweep(tid, carry):
        bt, bp, bu, bv, swept = carry
        for c in range(L // lc):
            cols = pl.ds(c * lc, lc)

            def row(r):
                return coef_ref[tid, r, cols][:, None]  # [lc, 1]

            # same operation order as `raster._sweep`
            un = dx * row(0) + dy * row(1) + dz * row(2)
            vn = dx * row(3) + dy * row(4) + dz * row(5)
            wn = dx * row(6) + dy * row(7) + dz * row(8)
            den = dx * row(9) + dy * row(10) + dz * row(11)
            tn = row(12)
            ok = jnp.minimum(
                jnp.minimum(un * den, vn * den), jnp.minimum(wn * den, tn * den)
            ) > 0
            safe = jnp.where(den != 0, den, 1.0)
            t = jnp.where(ok, tn / safe, BIGF)
            tmin = jnp.min(t, axis=0)  # [RPT]
            win = jnp.min(jnp.where(t == tmin[None, :], lane, lc), axis=0)
            best = lane == win[None, :]  # exactly one row per ray
            inv = 1.0 / safe
            u = jnp.min(jnp.where(best, un * inv, BIGF), axis=0)
            v = jnp.min(jnp.where(best, vn * inv, BIGF), axis=0)
            better = tmin < bt
            bt = jnp.where(better, tmin, bt)
            bp = jnp.where(better, tid * L + c * lc + win, bp)
            bu = jnp.where(better, u, bu)
            bv = jnp.where(better, v, bv)
        return bt, bp, bu, bv, swept + L

    def body(k, carry):
        tid = cand_ref[ct, k]
        live = ((bits_ref[ct, k] >> s) & 1) == 1
        # front-to-back order: once every ray of the subtile has a hit
        # closer than this candidate's entry bound, the candidate is dead
        live = live & (tlb_ref[ct, k] < jnp.max(carry[0]))
        return lax.cond(live, partial(sweep, tid), lambda c: c, carry)

    init = (
        jnp.full((RPT,), BIGF, F32),
        jnp.full((RPT,), -1, I32),
        jnp.zeros((RPT,), F32),
        jnp.zeros((RPT,), F32),
        jnp.zeros((), I32),
    )
    bt, bp, bu, bv, swept = lax.fori_loop(0, cnt_ref[ct], body, init)
    t_ref[rays] = bt
    p_ref[rays] = bp
    u_ref[rays] = bu
    v_ref[rays] = bv
    c_ref[rays] = jnp.full((RPT,), swept, I32)


def render_raster_triton(
    scene: R.RasterScene,
    rays: Rays,
    tr: Transformation,
    width: int,
    height: int,
    cand_cap: int = 1024,
    interpret: bool = False,
):
    """Raster render through the Triton kernel. Same hits as
    `raster.render_raster_xla` and the wavefront engine (up to t ties).

    Returns (HitInfo in x-major ray order, counts u32[R] = prims swept per
    ray, overflow bool[] — true when a coarse tile had more than
    `cand_cap` candidate treelets; the hits are then incomplete)."""
    return _render_impl(
        scene.tris_sorted, scene.prim_ids, rays, tr, width, height,
        cand_cap, scene.leaf_size, interpret,
    )


@partial(
    jax.jit,
    static_argnames=(
        "width", "height", "cand_cap", "leaf_size", "interpret",
    ),
)
def _render_impl(
    tris_sorted,
    prim_ids,
    rays: Rays,
    tr: Transformation,
    width: int,
    height: int,
    cand_cap: int,
    leaf_size: int,
    interpret: bool,
):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltr

    L = leaf_size
    assert L & (L - 1) == 0, "leaf_size must be a power of two"
    edge = SUB * CGRID
    if width % edge or height % edge:
        rp, wp, hp, crop = R.pad_frame(rays, width, height, edge)
        hit, counts, overflow = _render_impl(
            tris_sorted, prim_ids, rp, tr, wp, hp, cand_cap, leaf_size,
            interpret,
        )
        return HitInfo(*(crop(f) for f in hit)), crop(counts), overflow

    n_ct = (width * height) // RPC
    wt = A.transform_point(tris_sorted, tr.scale, tr.quat, tr.translation)
    bmin, bmax = R._treelet_aabbs(wt, prim_ids, L)
    eye = rays.origin[0]
    nt = bmin.shape[0]

    dirs_ct = _to_coarse_layout(rays.direction.reshape(width, height, 3),
                                width, height)  # [CT, 4096, 3]
    possible, t_lb = R._cone_vs_aabb(
        eye, jnp.min(dirs_ct, axis=1)[:, None, :],
        jnp.max(dirs_ct, axis=1)[:, None, :], bmin[None], bmax[None],
    )  # [CT, T]
    key = jnp.where(possible, t_lb, BIG)
    tid = jnp.broadcast_to(jnp.arange(nt, dtype=I32)[None, :], key.shape)
    key_s, tid_s = lax.sort((key, tid), num_keys=1)  # per-row front-to-back
    cc = min(cand_cap, nt)
    counts = jnp.sum(possible.astype(I32), axis=1)
    overflow = jnp.any(counts > cand_cap)
    in_cnt = jnp.arange(cc, dtype=I32)[None, :] < counts[:, None]
    cand = jnp.where(in_cnt, tid_s[:, :cc], nt)
    tlb = jnp.where(in_cnt, key_s[:, :cc], BIG)

    # per-(candidate, subtile) cone test -> one bitmask per candidate
    dsub = dirs_ct.reshape(n_ct, NSUB, RPT, 3)
    ab = jnp.concatenate([bmin, bmax], axis=1)
    ab = jnp.concatenate(
        [ab, jnp.concatenate([jnp.full((1, 3), BIG), jnp.full((1, 3), -BIG)], 1)]
    )[cand]  # [CT, cc, 6]
    live_s, _ = R._cone_vs_aabb(
        eye,
        jnp.min(dsub, axis=2)[:, None, :, :],
        jnp.max(dsub, axis=2)[:, None, :, :],
        ab[:, :, None, 0:3],
        ab[:, :, None, 3:6],
    )  # [CT, cc, NSUB]
    weights = jnp.left_shift(jnp.ones((NSUB,), I32), jnp.arange(NSUB, dtype=I32))
    bits = jnp.sum(jnp.where(live_s, weights, 0), axis=2)

    coef = _coef_table(wt, prim_ids, eye, L)
    dirs_k = dirs_ct.reshape(-1, 3).T  # [3, CT*4096]
    n = n_ct * RPC
    out_t, out_p, out_u, out_v, out_c = pl.pallas_call(
        _kernel,
        out_shape=(
            jax.ShapeDtypeStruct((n,), F32),
            jax.ShapeDtypeStruct((n,), I32),
            jax.ShapeDtypeStruct((n,), F32),
            jax.ShapeDtypeStruct((n,), F32),
            jax.ShapeDtypeStruct((n,), I32),
        ),
        grid=(n_ct, NSUB),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="raster_sweep",
    )(dirs_k, cand, tlb, bits, jnp.minimum(counts, cc), coef)

    flat = lambda x: _from_coarse_layout(x.reshape(n_ct, RPC, 1), width,
                                         height)[:, 0]
    t, prim, u, v = flat(out_t), flat(out_p), flat(out_u), flat(out_v)
    miss = prim < 0
    hit = HitInfo(
        prim_idx=jnp.where(miss, -1, prim_ids[jnp.maximum(prim, 0)]),
        t=jnp.where(miss, FLT_MAX, t),
        u=jnp.where(miss, 0.0, u),
        v=jnp.where(miss, 0.0, v),
    )
    return hit, flat(out_c).astype(jnp.uint32), overflow
