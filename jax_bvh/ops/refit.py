"""AABB refit for LBVH nodes — level-free, atomic-free.

The reference propagates leaf AABBs bottom-up with an atomic
"second-arrival-proceeds" climb (`TwoPassLbvhKernel.h:217-235`,
`SinglePassLbvhKernel.h:88-126`). Here a structural fact replaces the
atomics: every LBVH internal node covers a *contiguous* range of
Morton-sorted leaves, so its AABB is a range min/max over the leaf AABB
array, answered with a binary-lifting (sparse) table.

The table is built with dense clamped shifts and *stacked* into one
[(K+1)*n, 6] array so that all n-1 queries resolve with exactly two
row-gathers (one per window), instead of per-level gathers. Min and
negated max are packed so a single `minimum` covers both. Deterministic by
construction.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax

I32 = jnp.int32


def _floor_log2(x):
    return (31 - lax.clz(x.astype(jnp.uint32)).astype(I32)).astype(I32)


def _build_table(leaf_min, leaf_max, levels, min_level: int = 0):
    """Stacked binary-lifting min-table over (min, -max) rows.

    Built lane-major ([6, n] per level) and transposed once at the end
    into row layout for the row-gather queries. Levels below `min_level` are computed but not stacked (queries for
    ranges longer than 2^min_level never touch them)."""
    n = leaf_min.shape[0]
    packed_t = jnp.concatenate([leaf_min, -leaf_max], axis=1).T  # [6, n]
    tabs = [packed_t] if min_level == 0 else []
    cur = packed_t
    for k in range(1, levels + 1):
        s = 1 << (k - 1)
        if s < n:
            shifted = jnp.concatenate(
                [cur[:, s:], jnp.broadcast_to(cur[:, -1:], (6, s))], axis=1
            )
            cur = jnp.minimum(cur, shifted)
        if k >= min_level:
            tabs.append(cur)
    table_t = jnp.concatenate(tabs, axis=1)  # [6, (levels+1-min_level)*n]
    return table_t.T  # row layout for the gathers


def _query_table(table, n, first, last, min_level: int = 0):
    length = last - first + 1
    k = jnp.maximum(_floor_log2(length), min_level)
    b = jnp.maximum(last - (1 << k) + 1, 0)
    k0 = k - min_level
    return jnp.minimum(table[k0 * n + first], table[k0 * n + b])


def refit_anchored(leaf_min, leaf_max, first, last, radius: int = 16):
    """Row-major wrapper around `refit_anchored_packed` (see below).

    leaf_min/max: f32[n, 3]. Returns (node_min f32[m,3], node_max f32[m,3]).
    """
    n = leaf_min.shape[0]
    if radius < 15:
        return refit_ranges(leaf_min, leaf_max, first, last)
    packed_t = jnp.concatenate([leaf_min, -leaf_max], axis=1).T  # [6, n]
    out_t = refit_anchored_packed(packed_t, first, last, radius)
    out = out_t.T
    return out[:, :3], -out[:, 3:]


def refit_anchored_packed(packed_t, first, last, radius: int = 16):
    """Refit for boundary-ordered nodes (node i sits between leaves i, i+1
    with first <= i < i+1 <= last — the split-position layout).

    packed_t: f32[6, n] lane-major (rows = min xyz, -max xyz) — the layout
    the whole build pipeline carries.
    Returns packed f32[6, m] (min, -max) lane-major.

    Exploits that ranges *contain their own index*: any node whose range
    fits in (i-radius, i+radius] is resolved by a window of dense masked
    shifted unions — the overwhelming majority in Morton order. The rare
    long-range nodes are compacted to the front with one sort and resolved
    with two *small* table gathers. Degenerate scenes whose long count
    overflows the static budget (caterpillar Morton runs) dispatch at the
    top to an exact full-table path, before any heavy compute, so the
    cond's operands are just the inputs. Everything is deterministic.
    """
    n = packed_t.shape[1]
    m = first.shape[0]
    assert m == n - 1, "boundary-ordered refit requires one node per boundary"
    assert m < (1 << 22), "long-path key packs positions in 22 bits"
    assert radius >= 15, "packed path requires radius >= 15 (level-4 windows)"

    # long-node budget: #nodes with range length > L is ~2n/L in Morton
    # order (measured sponza 262K: 15.8K at R=16, 5.1K at R=48), so size
    # the static gather width to the radius with ~2x headroom
    cap = min(m, max(64, (4 * m) // (3 * radius)))
    i = jnp.arange(m, dtype=I32)
    short0 = (i - first < radius) & (last - i <= radius)
    n_long = m - jnp.sum(short0.astype(I32))
    if cap >= m:
        return _refit_anchored_fast(packed_t, first, last, radius, cap)
    return lax.cond(
        n_long <= cap,
        lambda: _refit_anchored_fast(packed_t, first, last, radius, cap),
        lambda: _refit_full_table(packed_t, first, last),
    )


def _refit_anchored_fast(packed_t, first, last, radius: int, cap: int):
    """The common path of `refit_anchored_packed`; exact whenever the
    long-node count fits `cap` (guaranteed by the caller's dispatch)."""
    n = packed_t.shape[1]
    m = first.shape[0]
    big = jnp.float32(3.0e38)
    i = jnp.arange(m, dtype=I32)

    short = (i - first < radius) & (last - i <= radius)
    # Dense phase in lane-major [6, *] layout: every shifted window is a
    # static lane slice of one padded array.
    pad_t = jnp.full((6, radius), big)
    padded_t = jnp.concatenate([pad_t, packed_t, pad_t], axis=1)  # [6, n+2R]
    acc_t = jnp.full((6, m), big)
    for d in range(-radius + 1, radius + 1):
        # window[:, i] = packed[i + d] (out-of-range lanes hold +big)
        shifted = lax.dynamic_slice(padded_t, (0, radius + d), (6, m))
        j = i + d
        valid = (j >= first) & (j <= last)
        acc_t = jnp.where(valid[None, :], jnp.minimum(acc_t, shifted), acc_t)

    # Long nodes (range exceeds the dense radius) resolve with a TWO-LEVEL
    # table: a single fine level-4 row (T4[i] = min over [i, i+16)) covers
    # both range ends, and a coarse lifting table over block-16 mins covers
    # the fully-contained middle blocks. The table stays lane-major
    # ([6, n + (Lc+1)*nb]) and the queries gather lanes.
    pt = packed_t  # [6, n]
    cur = pt
    for k in range(1, 5):
        s = 1 << (k - 1)
        if s < n:
            shifted = jnp.concatenate(
                [cur[:, s:], jnp.broadcast_to(cur[:, -1:], (6, s))], axis=1
            )
            cur = jnp.minimum(cur, shifted)
    nb = (n + 15) // 16
    padn = nb * 16
    ptp = pt if padn == n else jnp.concatenate(
        [pt, jnp.full((6, padn - n), big)], axis=1
    )
    c0 = ptp.reshape(6, nb, 16).min(axis=2)  # exact block-16 leaf mins
    levels_c = max(1, math.ceil(math.log2(max(nb, 2))))
    ctabs = [cur, c0]
    ccur = c0
    for k in range(1, levels_c + 1):
        s = 1 << (k - 1)
        if s < nb:
            shifted = jnp.concatenate(
                [ccur[:, s:], jnp.broadcast_to(ccur[:, -1:], (6, s))], axis=1
            )
            ccur = jnp.minimum(ccur, shifted)
        ctabs.append(ccur)
    table_t = jnp.concatenate(ctabs, axis=1)  # [6, X]: [T4 | coarse lvls]

    n_long = jnp.sum((~short).astype(I32))

    def query(cf, cl):
        # ends: two fine level-4 windows [cf, cf+16) and (cl-16, cl]
        u = jnp.minimum(table_t[:, cf], table_t[:, jnp.maximum(cl - 15, 0)])
        # middle: blocks fully inside [cf, cl] via the coarse lifting table
        bf = (cf + 15) >> 4
        bl = ((cl + 1) >> 4) - 1
        has_mid = bl >= bf  # guaranteed when cl - cf + 1 >= 32
        bfs = jnp.minimum(bf, nb - 1)
        cnt = jnp.maximum(bl - bfs + 1, 1)
        kc = _floor_log2(cnt)
        b2 = jnp.maximum(bl - (1 << kc) + 1, 0)
        uc = jnp.minimum(
            table_t[:, n + kc * nb + bfs], table_t[:, n + kc * nb + b2]
        )
        return jnp.minimum(u, jnp.where(has_mid[None, :], uc, big))

    # Long nodes to the front with ONE single-key unstable sort (the key
    # packs (short, position), so it is unique and long nodes land in the
    # first n_long slots in position order) — and the dense answers ride
    # the sort as payload, so after blending the table answers over the
    # first cap columns a second sort keyed by position is the whole
    # place-back. (Degenerate overflow is impossible here: the caller
    # dispatched on n_long <= cap before any of this ran.)
    key = (short.astype(jnp.uint32) << 22) | i.astype(jnp.uint32)
    as_ib = lambda x: lax.bitcast_convert_type(x, I32)
    as_fb = lambda x: lax.bitcast_convert_type(x, jnp.float32)
    accm = acc_t[:, :m]
    skey, cfq, clq, p0, p1, p2, p3, p4, p5 = lax.sort(
        (key, first, last,
         as_ib(accm[0]), as_ib(accm[1]), as_ib(accm[2]),
         as_ib(accm[3]), as_ib(accm[4]), as_ib(accm[5])),
        num_keys=1,
        is_stable=False,
    )
    ut = query(cfq[:cap], clq[:cap])  # [6, cap]
    rank_c = jnp.arange(cap, dtype=I32)

    # blend the table answers over the long ranks, then one sort by
    # position restores node order — payload rows are i32 bit views
    blend = rank_c < n_long
    full = [
        jnp.concatenate(
            [jnp.where(blend, as_ib(ut[k]), p[:cap]), p[cap:]]
        )
        for k, p in enumerate((p0, p1, p2, p3, p4, p5))
    ]
    out = lax.sort((skey & ((1 << 22) - 1), *full), num_keys=1,
                   is_stable=False)
    return jnp.stack([as_fb(o) for o in out[1:]], axis=0)  # [6, m]


def _refit_full_table(packed_t, first, last):
    """Exact full-table fallback for degenerate scenes (n_long > cap —
    caterpillar Morton runs): a complete binary-lifting table over the
    leaf columns + one two-gather query per node. ~4 m-wide lane gathers;
    never taken on realistic Morton distributions."""
    n = packed_t.shape[1]
    m = first.shape[0]
    levels = max(1, math.ceil(math.log2(max(n, 2))))
    tabs = [packed_t]
    cur = packed_t
    for k in range(1, levels + 1):
        s = 1 << (k - 1)
        if s < n:
            shifted = jnp.concatenate(
                [cur[:, s:], jnp.broadcast_to(cur[:, -1:], (6, s))], axis=1
            )
            cur = jnp.minimum(cur, shifted)
        tabs.append(cur)
    table_t = jnp.concatenate(tabs, axis=1)  # [6, (levels+1)*n]
    length = last - first + 1
    k = _floor_log2(length)
    b = jnp.maximum(last - (1 << k) + 1, 0)
    return jnp.minimum(table_t[:, k * n + first], table_t[:, k * n + b])


def refit_ranges(leaf_min, leaf_max, first, last):
    """AABBs for internal nodes covering sorted-leaf ranges [first, last].

    leaf_min/max: f32[n, 3] in Morton-sorted leaf order.
    first/last: i32[m] inclusive leaf ranges (last > first).
    Returns (node_min f32[m,3], node_max f32[m,3]).

    Sparse-table answer: with k = floor(log2(len)), the union of windows
    [first, first+2^k) and [last-2^k+1, last] covers the range exactly.
    """
    n = leaf_min.shape[0]
    levels = max(1, math.ceil(math.log2(max(n, 2))))

    packed = jnp.concatenate([leaf_min, -leaf_max], axis=1)  # [n, 6]
    tabs = [packed]
    cur = packed
    for k in range(1, levels + 1):
        s = 1 << (k - 1)
        if s < n:
            # clamped window: T_k[i] = min(T_{k-1}[i], T_{k-1}[min(i+s, n-1)])
            shifted = jnp.concatenate(
                [cur[s:], jnp.broadcast_to(cur[-1:], (s, 6))], axis=0
            )
            cur = jnp.minimum(cur, shifted)
        tabs.append(cur)
    table = jnp.concatenate(tabs, axis=0)  # [(levels+1)*n, 6]

    length = last - first + 1
    k = _floor_log2(length)
    b = jnp.maximum(last - (1 << k) + 1, 0)
    g1 = table[k * n + first]
    g2 = table[k * n + b]
    u = jnp.minimum(g1, g2)
    return u[:, :3], -u[:, 3:]
