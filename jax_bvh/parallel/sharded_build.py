"""Sharded single-scene LBVH build over a `jax.sharding.Mesh`.

SURVEY.md §5's missing scaling axis: one huge scene's triangles sharded
across devices, the whole build pipeline running SPMD with collectives
where the reference uses single-GPU global memory (the smem apron of
`src/Ploc++Kernel.h:220-227` becomes a ppermute halo; the
global radix sort becomes a deterministic PSRS sample sort — ONE ragged
all-to-all, not an O(p)-round merge-split network; the atomic-climb refit
becomes carry-combined scans + query routing with `lax.pmin`).

Everything is deterministic and **bit-identical** to the single-device
`models.lbvh.build_single_pass` tree:

* the distributed sort orders by the total key (code, original index),
  which is exactly what the single-device stable sort produces;
* the threshold scans use associative combines (max / segmented-min) whose
  cross-shard carry composition is the same operator, so integer outputs
  match exactly;
* AABB refit is pure f32 min/max — associative and exact in any grouping.

Per-shard layout (p shards, L = n/p): shard s owns sorted leaves
[sL, (s+1)L) and boundaries [sL, (s+1)L) (the last shard's final boundary
slot is a pad — global boundary m = n-1 does not exist; its delta is set
below every real value so reverse scans resolve "no next smaller" to the
n-1 sentinel naturally).

Degenerate scenes can exceed the long-node routing capacity; the build
then reports `overflow=True` (honest, like the traversal engines) and the
affected AABBs fall back to +/-inf — callers should rebuild unsharded.
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..types import Bvh2

I32 = jnp.int32
U32 = jnp.uint32
V = 64  # threshold lanes (delta alphabet remapped to [0, 52])
_BIG = jnp.int32(2**31 - 1)
_FBIG = jnp.float32(3.0e38)
_POSB = 22


def _clz32(x):
    return lax.clz(x.astype(U32)).astype(I32)


def _floor_log2(x):
    return (31 - _clz32(jnp.maximum(x, 1))).astype(I32)


# ---------------------------------------------------------------------------
# distributed sort: deterministic PSRS sample sort (O(1) collective rounds)
# ---------------------------------------------------------------------------
#
# Replaces the r4 odd-even transposition network, whose O(p) merge-split
# rounds made the scaling table ANTI-scale (more devices = more rounds).
# Schedule: local sort -> regular-sample splitter broadcast -> ONE ragged
# all-to-all by splitter bucket -> local sort of the bucket -> one +-1
# neighbor balance exchange that restores the exact [sL, (s+1)L) global
# rank ownership. Regular sampling bounds the splitter-rank drift to
# |R_b - b*L| <= L (each shard contributes its kL/p-th items; the b*p-th
# sample has between bL-1 and bL+L smaller elements), so every bucket fits
# 2L+2 slots and the balance pass only ever touches direct neighbors.
# Deterministic: the sort key (code, gidx) is a total order, splitters are
# rank-chosen, and the drift bound is checked (overflow=True on violation
# — degenerate only if the sampling identity itself is broken).


def _psrs_key_le(sc, sg, c, g):
    """(sc, sg) <= (c, g) in (u32, i32-nonneg) lexicographic order."""
    return (sc < c) | ((sc == c) & (sg <= g))


def _sample_sort(ops, p, axis, L):
    """ops: 8 channels [L] (codes u32, gidx i32, 6 f32), locally sorted by
    (code, gidx). Returns (ops with shard s owning global ranks
    [sL, (s+1)L) fully sorted, overflow bool)."""
    if p == 1:
        return ops, jnp.zeros((), bool)
    s_idx = lax.axis_index(axis)
    codes, gidx = ops[0], ops[1]
    C = 2 * L + 8  # bucket capacity (PSRS bound 2L+2, padded up)

    # ---- splitters from regular samples ----
    samp_pos = (jnp.arange(p, dtype=I32) + 1) * L // p - 1
    sc = codes[samp_pos]
    sg = gidx[samp_pos]
    all_sc = lax.all_gather(sc, axis).reshape(p * p)
    all_sg = lax.all_gather(sg, axis).reshape(p * p)
    all_sc, all_sg = lax.sort((all_sc, all_sg), num_keys=2)
    spl_c = all_sc[jnp.arange(1, p, dtype=I32) * p - 1]  # [p-1]
    spl_g = all_sg[jnp.arange(1, p, dtype=I32) * p - 1]

    # ---- destination bucket per item (non-decreasing: array is sorted) --
    dst = jnp.sum(
        _psrs_key_le(
            spl_c[None, :], spl_g[None, :], codes[:, None], gidx[:, None]
        ).astype(I32),
        axis=1,
    )  # [L] in [0, p)
    counts = jnp.sum(
        dst[:, None] == jnp.arange(p, dtype=I32)[None, :], axis=0
    )  # [L]->[p]
    in_off = jnp.concatenate(
        [jnp.zeros((1,), I32), jnp.cumsum(counts)[:-1]]
    )
    cmat = lax.all_gather(counts, axis)  # [p_src, p_dst]

    # ---- exchange: masked all-gather + ONE local merge sort ----
    # The bucket exchange is logically a ragged all-to-all; XLA:CPU (the
    # virtual-device mesh every test and the driver dryrun validate on)
    # does not implement `ragged-all-to-all`, so the portable form gathers
    # each channel and masks to my runs — item (src, i) is mine iff
    # in_off_src[me] <= i < in_off_src[me] + cmat[src, me]. One 8-channel
    # sort of the gathered block then merges the runs (fill keys sort
    # last) and the bucket is its first C columns. Still O(1) collective
    # rounds — the O(p) round count, not bytes, is what made the odd-even
    # network anti-scale. `lax.ragged_all_to_all` can replace the
    # gather+mask verbatim: send
    # sizes = counts, input offsets = in_off, output offsets = the
    # column-wise exclusive cumsum of cmat, recv sizes = cmat[:, me].
    fill = [jnp.uint32(0xFFFFFFFF), _BIG] + [_BIG] * 6  # pad keys sort last
    io_all = lax.all_gather(in_off, axis)  # [p_src, p_dst]
    lo_run = io_all[:, s_idx][:, None]  # [p, 1]
    hi_run = lo_run + cmat[:, s_idx][:, None]
    ii = jnp.arange(L, dtype=I32)[None, :]
    mine = (ii >= lo_run) & (ii < hi_run)
    flat = []
    for k, op in enumerate(ops):
        ab = lax.all_gather(op, axis)  # [p, L]
        f = fill[k] if k < 2 else jnp.float32(_FBIG)
        flat.append(jnp.where(mine, ab, f).reshape(p * L))
    merged = lax.sort(tuple(flat), num_keys=2, is_stable=False)
    buf = [x[:C] for x in merged]

    # ---- global bucket offsets + drift-bound honesty check ----
    sizes = jnp.sum(cmat, axis=0)  # [p] destination bucket sizes
    r_all = jnp.concatenate(
        [jnp.zeros((1,), I32), jnp.cumsum(sizes)]
    )  # [p+1] exclusive bucket ranks
    drift = jnp.max(
        jnp.abs(r_all[:p] - jnp.arange(p, dtype=I32) * L)
    )
    overflow = (drift > L) | (jnp.max(sizes) > C)

    # ---- +-1 neighbor balance: exchange tails/heads, rank-slice ----
    # My final item of global rank g comes from the left bucket (g <
    # r_mine), my own bucket, or the right bucket (g >= r_mine + mysize);
    # the drift bound makes those the ONLY possibilities. Each candidate is
    # one dynamic_slice whose start stays un-clamped by construction:
    #   left  : from_left[j'] has rank (r_mine - L) + j'; start = lo_want -
    #           r_mine + L in [0, 2L]  (back-pad 2L)
    #   mine  : start = lo_want - r_mine in [-L, L]       (front-pad L)
    #   right : from_right[j'] has rank r_next + j'; start = lo_want -
    #           r_next in [-2L, 0]                        (front-pad 2L)
    # Consumed lanes are always valid: lo_want >= r_all[s-1] and
    # lo_want + L <= r_next + L, again by the drift bound.
    mysize = sizes[s_idx]
    r_mine = r_all[s_idx]
    r_next = r_all[jnp.minimum(s_idx + 1, p)]
    right_to_left = [(t, t - 1) for t in range(1, p)]
    left_to_right = [(t, t + 1) for t in range(p - 1)]
    lo_want = s_idx * L
    j = jnp.arange(L, dtype=I32)
    gr = lo_want + j
    use_l = gr < r_mine
    use_r = gr >= r_mine + mysize
    outs = []
    for k, b in enumerate(buf):
        f = fill[k] if k < 2 else jnp.float32(_FBIG)
        pad = lambda m: jnp.full((m,), f, b.dtype)
        # left neighbor's last L valid items travel right (front-padded
        # slice covers buckets smaller than L)
        bp = jnp.concatenate([pad(L), b])
        tailL = lax.dynamic_slice(bp, (mysize,), (L,))
        from_left = lax.ppermute(tailL, axis, left_to_right)
        # right neighbor's first L items travel left
        from_right = lax.ppermute(b[:L], axis, right_to_left)
        cl = lax.dynamic_slice(
            jnp.concatenate([from_left, pad(2 * L)]),
            (lo_want - r_mine + L,), (L,),
        )
        cm = lax.dynamic_slice(bp, (lo_want - r_mine + L,), (L,))
        cr = lax.dynamic_slice(
            jnp.concatenate([pad(2 * L), from_right]),
            (lo_want - r_next + 2 * L,), (L,),
        )
        outs.append(jnp.where(use_l, cl, jnp.where(use_r, cr, cm)))
    return outs, overflow


# ---------------------------------------------------------------------------
# carry-combined threshold scans
# ---------------------------------------------------------------------------


def _seg_comb(a, b):
    """Segmented-min combine over (min, reset_seen) pairs."""
    mm = jnp.where(b[1], b[0], jnp.minimum(a[0], b[0]))
    return (mm, a[1] | b[1])


def _carry_fold(items, neutral, comb):
    """Exclusive prefix fold of per-shard totals (small static loop)."""
    p = items[0].shape[0]
    outs = []
    acc = neutral
    for s in range(p):
        outs.append(acc)
        acc = comb(acc, tuple(x[s] for x in items))
    return [jnp.stack([o[k] for o in outs]) for k in range(len(neutral))]


def _sharded_scans(dlt, gb, axis, p, n_sentinel):
    """Global psv/nsv/lc/rc for this shard's boundaries.

    dlt: i32[L] remapped deltas [0, 52] (pad slots hold -1: below every
    real value). gb: i32[L] global boundary indices.
    Returns (psv, psv_val, nsv, nsv_val, lc, rc) with global positions.
    """
    L = dlt.shape[0]
    idx = lax.axis_index(axis)
    vr = jnp.arange(V, dtype=I32)
    maskv = dlt[:, None] < vr[None, :]
    onehot = dlt[:, None] == vr[None, :]

    # ---- psv: running max of packed pos*64+val where val < lane ----
    # pad boundary (global n-1) carries dlt = -1 so it is a universal
    # candidate, but packs val 0; its decoded position n-1 IS the "no next
    # smaller" sentinel, so reverse scans resolve naturally.
    packed = gb * 64 + jnp.maximum(dlt, 0)
    pk = jnp.where(maskv, packed[:, None], -1)
    pre = lax.cummax(pk, axis=0)
    tot = pre[-1]  # [V]
    tots = lax.all_gather(tot, axis)  # [p, V]
    carry_in = _carry_fold(
        (tots,), (jnp.full((V,), -1, I32),),
        lambda a, b: (jnp.maximum(a[0], b[0]),),
    )[0][idx]
    pre_g = jnp.maximum(pre, carry_in[None, :])
    psv_rows = jnp.concatenate([carry_in[None, :], pre_g[:-1]], axis=0)
    # one-hot select by SUM (a max would let the 0 fill beat the -1 "none")
    ppk = jnp.sum(jnp.where(onehot, psv_rows, 0), axis=1)
    has = ppk >= 0
    psv = jnp.where(has, ppk // 64, -1)
    psv_val = jnp.where(has, ppk % 64, -1)

    # ---- nsv: suffix min of packed pos*64+val where val < lane ----
    pk2 = jnp.where(maskv, packed[:, None], _BIG)
    suf = lax.cummin(pk2, axis=0, reverse=True)
    tot_r = suf[0]
    tots_r = lax.all_gather(tot_r, axis)
    # exclusive suffix fold: combine shards AFTER s
    def _suffix_fold(items):
        outs = []
        acc = jnp.full((V,), _BIG, I32)
        res = [None] * p
        for s in range(p - 1, -1, -1):
            res[s] = acc
            acc = jnp.minimum(acc, items[s])
        return jnp.stack(res)

    carry_in_r = _suffix_fold(tots_r)[idx]
    suf_g = jnp.minimum(suf, carry_in_r[None, :])
    nsv_rows = jnp.concatenate([suf_g[1:], carry_in_r[None, :]], axis=0)
    npk = jnp.sum(jnp.where(onehot, nsv_rows, 0), axis=1)
    hasn = npk != _BIG
    nsv = jnp.where(hasn, npk // 64, -1)  # caller maps -1 -> n-1 sentinel
    # the pad boundary decodes to the n-1 sentinel position; its packed val
    # is a placeholder 0 — report -1 ("no real next-smaller") there, which
    # is what the side comparison psv_val > nsv_val needs
    nsv_val = jnp.where(hasn & (nsv < n_sentinel), npk % 64, -1)

    # ---- lc: exclusive segmented min (reset where dlt <= lane) ----
    cpacked = (dlt << _POSB) | gb
    cand = jnp.where(dlt[:, None] > vr[None, :], cpacked[:, None], _BIG)
    reset = dlt[:, None] <= vr[None, :]
    m_f, r_f = lax.associative_scan(_seg_comb, (cand, reset), axis=0)
    tots_m = lax.all_gather(m_f[-1], axis)
    tots_r2 = lax.all_gather(r_f[-1], axis)
    cm, cr = _carry_fold(
        (tots_m, tots_r2),
        (jnp.full((V,), _BIG, I32), jnp.zeros((V,), bool)),
        _seg_comb,
    )
    cm_in, _cr_in = cm[idx], cr[idx]
    m_g = jnp.where(r_f, m_f, jnp.minimum(cm_in[None, :], m_f))
    m_excl = jnp.concatenate([cm_in[None, :], m_g[:-1]], axis=0)
    lpk = jnp.max(jnp.where(onehot, m_excl, 0), axis=1)
    lc = jnp.where(lpk == _BIG, -1, lpk & ((1 << _POSB) - 1))

    # ---- rc: reverse segmented min, exclusive after position ----
    m_r, r_r = lax.associative_scan(
        _seg_comb, (cand[::-1], reset[::-1]), axis=0
    )
    m_r = m_r[::-1]
    r_r = r_r[::-1]
    tots_mr = lax.all_gather(m_r[0], axis)
    tots_rr = lax.all_gather(r_r[0], axis)

    def _suffix_fold2(items_m, items_r):
        acc = (jnp.full((V,), _BIG, I32), jnp.zeros((V,), bool))
        res = [None] * p
        for s in range(p - 1, -1, -1):
            res[s] = acc
            acc = _seg_comb(acc, (items_m[s], items_r[s]))
        return (jnp.stack([r[0] for r in res]), jnp.stack([r[1] for r in res]))

    cmr, _crr = _suffix_fold2(tots_mr, tots_rr)
    cmr_in = cmr[idx]
    m_rg = jnp.where(r_r, m_r, jnp.minimum(cmr_in[None, :], m_r))
    m_excl_r = jnp.concatenate([m_rg[1:], cmr_in[None, :]], axis=0)
    rpk = jnp.max(jnp.where(onehot, m_excl_r, 0), axis=1)
    rc = jnp.where(rpk == _BIG, -1, rpk & ((1 << _POSB) - 1))

    return psv, psv_val, nsv, nsv_val, lc, rc


# ---------------------------------------------------------------------------
# sharded refit: halo dense phase + routed long-node queries
# ---------------------------------------------------------------------------


def _halo_cols(cols, radius, axis, p):
    """[6, L] -> [6, L + 2*radius] with neighbor halos (+big at mesh edges)."""
    idx = lax.axis_index(axis)
    # partial permutations: unmatched destinations receive zeros, which the
    # mesh-edge masks below override with +big
    right_of = [(s, s + 1) for s in range(p - 1)]
    left_of = [(s, s - 1) for s in range(1, p)]
    # halo from the LEFT neighbor: its last `radius` cols travel rightward
    from_left = lax.ppermute(cols[:, -radius:], axis, right_of)
    from_right = lax.ppermute(cols[:, :radius], axis, left_of)
    from_left = jnp.where(idx > 0, from_left, _FBIG)
    from_right = jnp.where(idx < p - 1, from_right, _FBIG)
    return jnp.concatenate([from_left, cols, from_right], axis=1)


def _local_range_table(cols, levels):
    """T_k[i] = min(cols[i : i + 2^k]) clamped, stacked rows [(Lv+1)*L, 6]."""
    L = cols.shape[1]
    tabs = [cols]
    cur = cols
    for k in range(1, levels + 1):
        s = 1 << (k - 1)
        if s < L:
            shifted = jnp.concatenate(
                [cur[:, s:], jnp.broadcast_to(cur[:, -1:], (6, s))], axis=1
            )
            cur = jnp.minimum(cur, shifted)
        tabs.append(cur)
    return jnp.concatenate(tabs, axis=1).T  # [(levels+1)*L, 6]


def _answer_clamped(table, L, levels, lo, cf, cl):
    """min over leaves [cf, cl] ∩ [lo, lo+L) from this shard's table."""
    a = jnp.clip(cf - lo, 0, L - 1)
    b = jnp.clip(cl - lo, 0, L - 1)
    nonempty = (cf <= lo + L - 1) & (cl >= lo) & (b >= a)
    length = jnp.maximum(b - a + 1, 1)
    k = _floor_log2(length)
    s = jnp.maximum(b - (1 << k) + 1, 0)
    u = jnp.minimum(table[k * L + a], table[k * L + s])
    return jnp.where(nonempty[:, None], u, _FBIG)


class ShardedBvh2(NamedTuple):
    """Per-shard build outputs (all [p*L]-sharded along the mesh axis),
    plus the replicated root and the routing-overflow honesty flag."""

    int_packed: jax.Array  # f32[p*L, 6] internal (min,-max); last slot pad
    leaf_packed: jax.Array  # f32[p*L, 6] sorted leaves (min,-max)
    left: jax.Array  # i32[p*L]
    right: jax.Array  # i32[p*L]
    parent_internal: jax.Array  # i32[p*L]
    parent_leaf: jax.Array  # i32[p*L]
    leaf_prim: jax.Array  # i32[p*L]
    root: jax.Array  # i32[] replicated
    overflow: jax.Array  # bool[] replicated


def build_single_pass_sharded(
    mesh: Mesh,
    tris,
    axis: str = "dp",
    radius: int = 16,
    use_extended: bool = True,
    route_cap: int | None = None,
):
    """Sharded single-pass LBVH build (see module docstring). tris must
    have n % p == 0 and n/p >= 2*radius. Returns ShardedBvh2; use
    `to_bvh2` to assemble the standard replicated Bvh2. `route_cap`
    overrides the per-shard long-node routing capacity (testing hook)."""
    p = mesh.devices.size
    n = int(tris.shape[0])
    assert n % p == 0, "triangle count must divide the mesh"
    L = n // p
    assert L >= max(2 * radius, 64), "shards too small"
    cap = route_cap or min(L, max(128, ((L // 4 + 127) // 128) * 128))
    assert cap <= L
    tris = jax.device_put(tris, NamedSharding(mesh, P(axis)))
    return ShardedBvh2(*_build_sharded(tris, mesh, axis, radius, use_extended, cap))


# jitted around the shard_map, so the mesh runs one compiled program
@partial(jax.jit, static_argnames=("mesh", "axis", "radius", "use_extended", "cap"))
def _build_sharded(tris, mesh, axis, radius, use_extended, cap):
    p = mesh.devices.size
    n = tris.shape[0]
    L = n // p
    m = n - 1
    levels_loc = max(1, math.ceil(math.log2(max(L, 2))))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(
            P(axis), P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
            P(), P(),
        ),
        check_vma=False,
    )
    def _build(local_tris):
        s = lax.axis_index(axis)
        lo = s * L  # global offset of this shard's leaves/boundaries
        t9 = local_tris.reshape(L, 9).T
        mnx = jnp.minimum(jnp.minimum(t9[0], t9[3]), t9[6])
        mny = jnp.minimum(jnp.minimum(t9[1], t9[4]), t9[7])
        mnz = jnp.minimum(jnp.minimum(t9[2], t9[5]), t9[8])
        mxx = jnp.maximum(jnp.maximum(t9[0], t9[3]), t9[6])
        mxy = jnp.maximum(jnp.maximum(t9[1], t9[4]), t9[7])
        mxz = jnp.maximum(jnp.maximum(t9[2], t9[5]), t9[8])

        # global scene extents: the reference's atomicGrow reduction
        # (CommonBlocksKernel.h:92-137) as a deterministic all-reduce
        smin = jnp.stack(
            [lax.pmin(jnp.min(c), axis) for c in (mnx, mny, mnz)]
        )
        smax = jnp.stack(
            [lax.pmax(jnp.max(c), axis) for c in (mxx, mxy, mxz)]
        )
        ext = smax - smin
        safe = jnp.where(ext > 0, ext, 1.0)
        nx = ((mnx + mxx) * 0.5 - smin[0]) / safe[0]
        ny = ((mny + mxy) * 0.5 - smin[1]) / safe[1]
        nz = ((mnz + mxz) * 0.5 - smin[2]) / safe[2]
        from ..ops import morton as M

        if use_extended:
            codes = M.extended_morton30_cols(nx, ny, nz, ext)
        else:
            codes = M.morton30_cols(nx, ny, nz)

        # ---- distributed sort by the total key (code, original index) ----
        gidx = lo + jnp.arange(L, dtype=I32)
        ops = [codes, gidx, mnx, mny, mnz, -mxx, -mxy, -mxz]
        ops = list(lax.sort(tuple(ops), num_keys=2, is_stable=False))
        ops, sort_ovf = _sample_sort(ops, p, axis, L)
        codes, leaf_prim = ops[0], ops[1]
        leaf_cols = jnp.stack(ops[2:8], axis=0)  # [6, L] (min, -max)

        # ---- boundary deltas (halo: next shard's first code) ----
        nxt = lax.ppermute(
            codes[:1], axis, [(t, t - 1) for t in range(1, p)] + [(0, p - 1)]
        )[0]
        cj = jnp.concatenate([codes[1:], nxt[None]])
        gb = lo + jnp.arange(L, dtype=I32)
        x = codes ^ cj
        tie = 32 + _clz32(gb.astype(U32) ^ (gb + 1).astype(U32))
        dlt_raw = jnp.where(x == 0, tie, _clz32(x))
        dlt = jnp.where(dlt_raw <= 31, dlt_raw - 2, dlt_raw - 11)
        dlt = jnp.where(gb < m, dlt, -1)  # pad boundary: below everything

        psv, psv_val, nsv_p, nsv_val, lc, rc = _sharded_scans(
            dlt, gb, axis, p, m
        )
        first = psv + 1
        last = jnp.where(nsv_p >= 0, nsv_p, n - 1)

        # ---- refit: dense halo stencil ----
        halo = _halo_cols(leaf_cols, radius, axis, p)
        acc = jnp.full((6, L), _FBIG)
        li = jnp.arange(L, dtype=I32)
        la = last - gb
        ab = gb - first
        for d in range(-radius + 1, radius + 1):
            w = lax.dynamic_slice(halo, (0, radius + d), (6, L))
            # ranges contain their own boundary: one-sided checks suffice
            ok = (d <= la) if d > 0 else (-d <= ab)
            acc = jnp.where(ok[None, :], jnp.minimum(acc, w), acc)
        short = (ab < radius) & (la <= radius) & (gb < m)

        # ---- long nodes: compact, broadcast, answer, pmin, route back ----
        table = _local_range_table(leaf_cols, levels_loc)
        is_long = (~short) & (gb < m)
        n_long = jnp.sum(is_long.astype(I32))
        key = (~is_long).astype(U32)
        _, cf, cl, cpos = lax.sort(
            (key, first, last, li), num_keys=1, is_stable=True
        )
        cfq, clq = cf[:cap], cl[:cap]
        allq = lax.all_gather(jnp.stack([cfq, clq], axis=0), axis)  # [p,2,cap]
        qf = allq[:, 0].reshape(p * cap)
        ql = allq[:, 1].reshape(p * cap)
        ans_local = _answer_clamped(table, L, levels_loc, lo, qf, ql)
        ans = lax.pmin(ans_local, axis)  # [p*cap, 6]
        mine = lax.dynamic_slice(ans, (s * cap, 0), (cap, 6)).T  # [6, cap]
        rank = jnp.arange(L, dtype=I32)
        in_long = rank < jnp.minimum(n_long, cap)
        pad = jnp.full((L - cap,), _FBIG)
        cols_back = [
            jnp.where(in_long, jnp.concatenate([mine[k], pad]), _FBIG)
            for k in range(6)
        ]
        back = lax.sort(tuple([cpos] + cols_back), num_keys=1)
        long_cols = list(back[1:])
        int_packed = jnp.stack(
            [jnp.where(short, acc[k], long_cols[k]) for k in range(6)],
            axis=0,
        )
        overflow = (
            lax.pmax((n_long > cap).astype(I32), axis) > 0
        ) | (lax.pmax(sort_ovf.astype(I32), axis) > 0)

        # ---- links (apetrei layout, global ids) ----
        is_root = (first == 0) & (last == n - 1) & (gb < m)
        internal_is_right = psv_val > nsv_val
        nsv_link = last
        parent_internal = jnp.where(
            is_root, I32(-1),
            jnp.where(internal_is_right, psv, nsv_link),
        )
        # leaf j's parents need dlt[j-1]: one-left halo
        prv_d = lax.ppermute(
            dlt[-1:], axis, [(t, t + 1) for t in range(p - 1)] + [(p - 1, 0)]
        )[0]
        prv_d = jnp.where(s > 0, prv_d, I32(-1))
        ldl = jnp.concatenate([prv_d[None], dlt[:-1]])
        ldr = jnp.where(gb < m, dlt, -1)
        leaf_is_right = ldl > ldr
        parent_leaf = jnp.where(leaf_is_right, gb - 1, gb)
        left = jnp.where(lc >= 0, lc, m + gb)
        right = jnp.where(rc >= 0, rc, m + gb + 1)
        left = jnp.where(gb < m, left, -1)
        right = jnp.where(gb < m, right, -1)

        root_cand = jnp.min(jnp.where(is_root, gb, _BIG))
        root = lax.pmin(root_cand, axis)

        return (
            int_packed.T, leaf_cols.T, left, right, parent_internal,
            parent_leaf, leaf_prim, root, overflow,
        )

    return _build(tris)


def to_bvh2(sb: ShardedBvh2, n: int) -> Bvh2:
    """Assemble the standard replicated Bvh2 (node slots [0, 2n-2], leaves
    at [n-1, 2n-2], leaf.left = prim id — `TwoPassLbvhKernel.h:145-152`)."""
    m = n - 1
    int_packed = jnp.asarray(sb.int_packed)[:m]
    leaf_packed = jnp.asarray(sb.leaf_packed)
    packed_t = jnp.concatenate([int_packed, leaf_packed], axis=0).T
    left = jnp.concatenate(
        [jnp.asarray(sb.left)[:m], jnp.asarray(sb.leaf_prim)]
    )
    right = jnp.concatenate(
        [jnp.asarray(sb.right)[:m], jnp.full((n,), -1, I32)]
    )
    return Bvh2(
        packed_t=packed_t, left=left, right=right,
        root=jnp.asarray(sb.root),
    )
