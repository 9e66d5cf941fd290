"""PLOC++ agglomerative clustering — and its HPLOC-style guided variant.

Re-expression of the reference's PLOC++ kernels
(`src/Ploc++Kernel.h:98-362`) and HPLOC
(`HplocKernel.h:220-314`). The reference's machinery — shared-memory chunks
with aprons, warp-ballot prefix sums, atomicMin-encoded nearest neighbors,
cross-block serialized offsets — exists to emulate what a vector machine
does natively:

* nearest-neighbor search within Morton-order radius 8 = shifted
  whole-array AABB unions + a lexicographic (area, index) min-reduction
  (the reference's `(float_bits(area) << 32) | index` atomicMin encoding,
  `Ploc++Kernel.h:140-146`, without the atomics);
* mutual-pair merge + compaction = masked cumsums and one stable sort;
* the host `while (nClusters > 1)` loop with its per-round device->host
  readback (`PLOC++Bvh.cpp:132-152`) = `lax.while_loop`s on device.

Every neighbor access exploits that PLOC neighbors live within +-radius in
sorted order: `nn[i]`, `cnode[nn[i]]`, `aabb[nn[i]]` are (2R+1)-way dense
selects over shifted arrays, never gathers. Cluster state is
struct-of-columns; compaction is one stable multi-operand sort; each
round's merged nodes get a contiguous id slab and are emitted with a
blended dynamic-slice write into a lane-major buffer. Clusters stay
compacted at the front, and a static stage ladder of geometrically
shrinking widths keeps late rounds from paying full-width work.

Merged nodes are allocated top-down (`nClusters - 2 - prefix`,
`Ploc++Kernel.h:311`) so the root lands at index 0 — the same convention,
but deterministic (in cluster order) instead of warp-race order.

The HPLOC variant (`hploc=True`) restricts merges to clusters sharing a
Morton-prefix segment, coarsening the prefix by 3 bits every round (a
level-by-level bottom-up sweep through LBVH subtrees — the role the
reference's warp-cooperative `plocMerge` plays inside LBVH ranges,
`HplocKernel.h:257-314`; unconditional coarsening avoids burning
full-width rounds on stalls). Same output family (root at 0); the subtree
schedule is prefix-quantized rather than exact-range.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..types import PLOC_RADIUS

I32 = jnp.int32
U32 = jnp.uint32
INVALID = jnp.int32(-1)
_BIG = jnp.float32(3.0e38)
# Stage ladder: each stage is one `lax.while_loop` at a static width that
# halves from stage to stage, so late rounds do not pay full-width work.
# Every stage is compiled separately, and below ~32K clusters a round costs
# about its kernel launches whatever the width, so the ladder stays short.
_STAGE_RATIO = 2.0
_MIN_STAGE = 32768


def _shift(x, d, fill):
    """out[i] = x[i + d] with `fill` beyond the edges (dense slicing)."""
    n = x.shape[0]
    if d == 0:
        return x
    if d > 0:
        if d >= n:
            return jnp.full_like(x, fill)
        return jnp.concatenate([x[d:], jnp.full((d,), fill, x.dtype)])
    d = -d
    if d >= n:
        return jnp.full_like(x, fill)
    return jnp.concatenate([jnp.full((d,), fill, x.dtype), x[:-d]])


def _area6(c):
    """Surface area from packed (min3, -max3) columns c: tuple of 6 [n]."""
    ex = -c[3] - c[0]
    ey = -c[4] - c[1]
    ez = -c[5] - c[2]
    return 2.0 * (ex * ey + ex * ez + ey * ez)


def _nn_round_xla(mat, cols, seg, valid, idx, n_clusters, size, R):
    """NN stage: bounded-offset window views over a padded lane-major
    matrix. Returns (merge bool[S], dropped bool[S], union AABB columns,
    partner node i32[S])."""
    as_i = lambda x: lax.bitcast_convert_type(x, I32)
    pad = jnp.full((8, R), _BIG)
    matp = jnp.concatenate([pad, mat, pad], axis=1)  # [8, size + 2R]

    def win(d):
        """matp window shifted by d: w[:, i] = mat[:, i + d] (pad beyond)."""
        return lax.dynamic_slice(matp, (0, R + d), (8, size))

    # --- nearest neighbors: forward pairs (i, i+d), considered from both ends
    best_area = jnp.full((size,), _BIG)
    best_rel = jnp.zeros((size,), I32)  # relative offset of best neighbor

    for d in range(1, R + 1):
        w = win(d)
        u = [jnp.minimum(cols[k], w[k]) for k in range(6)]
        area = _area6(u)
        ok = valid & (idx + d < n_clusters) & (seg == as_i(w[6]).astype(U32))
        area = jnp.where(ok, area, _BIG)
        # forward candidate for i: neighbor i+d
        better = area < best_area
        best_area = jnp.where(better, area, best_area)
        best_rel = jnp.where(better, d, best_rel)
        # backward candidate for i+d: neighbor (i+d)-d; shift area right.
        # On equal areas the SMALLER absolute neighbor id wins (the
        # reference's packed (area_bits << 32 | index) atomicMin order,
        # `Ploc++Kernel.h:140-146`).
        area_b = _shift(area, -d, _BIG)
        better_b = (area_b < best_area) | (
            (area_b == best_area) & (idx - d < idx + best_rel)
        )
        best_area = jnp.where(better_b, area_b, best_area)
        best_rel = jnp.where(better_b, -d, best_rel)

    has_nn = best_area < _BIG
    # nn[nn[i]] via (2R+1)-way dense select on the bounded offset
    relp = jnp.concatenate(
        [jnp.zeros((1, R), I32), best_rel[None, :], jnp.zeros((1, R), I32)],
        axis=1,
    )
    rel_at_nn = jnp.zeros((size,), I32)
    for r in range(-R, R + 1):
        if r == 0:
            continue
        shifted_rel = lax.dynamic_slice(relp, (0, R + r), (1, size))[0]
        rel_at_nn = jnp.where(best_rel == r, shifted_rel, rel_at_nn)
    mutual = has_nn & valid & (rel_at_nn == -best_rel)
    merge = mutual & (best_rel > 0)  # left partner (smaller index) merges
    dropped = mutual & (best_rel < 0)

    # partner data via bounded-offset window selects
    rnode = jnp.zeros((size,), I32)
    pcols = [jnp.zeros((size,), jnp.float32) for _ in range(6)]
    for r in range(1, R + 1):
        sel = best_rel == r
        w = win(r)
        rnode = jnp.where(sel, as_i(w[7]), rnode)
        for k in range(6):
            pcols[k] = jnp.where(sel, w[k], pcols[k])
    ucols = [jnp.minimum(a, b) for a, b in zip(cols, pcols)]
    return merge, dropped, ucols, rnode


def _round(state, n0: int, radius: int, shift_step: int = 3):
    """One PLOC merge round over packed state (nc, shift_bits, mat, nodes).
    `n0` (static) = initial leaf count; merged-node ids are allocated
    BOTTOM-UP (base = n0 - nc) and flipped to the reference's root-at-0
    numbering once at the end of the build (see
    `ploc_build_topology_packed`).

    mat is lane-major f32[8, S]: rows 0..5 AABB (min3, -max3), row 6 the
    Morton code (u32 bitcast), row 7 the cluster node id (i32 bitcast).

    The bounded-offset NN stage plus two stable sorts (emit slab +
    survivor compaction)."""
    (n_clusters, shift_bits, mat, nodes) = state
    size = mat.shape[1]
    R = radius
    as_f = lambda x: lax.bitcast_convert_type(x, jnp.float32)
    as_i = lambda x: lax.bitcast_convert_type(x, I32)

    base = jnp.asarray(n0, I32) - n_clusters  # bottom-up ids allocated so far
    cols = [as_f(mat[k]) for k in range(6)]
    ccode = mat[6].astype(U32)
    cnode = mat[7]
    idx = jnp.arange(size, dtype=I32)
    valid = idx < n_clusters
    seg = jnp.where(
        shift_bits >= 32, U32(0), ccode >> jnp.minimum(shift_bits, 31).astype(U32)
    )
    segmat = jnp.stack(
        cols + [as_f(seg.astype(I32)), as_f(cnode)], axis=0
    )
    merge, dropped, ucols, rnode = _nn_round_xla(
        segmat, cols, seg, valid, idx, n_clusters, size, R
    )

    rank = jnp.cumsum(merge.astype(I32)) - merge.astype(I32)
    n_merged = jnp.sum(merge.astype(I32))
    # This round's nodes occupy the contiguous BOTTOM-UP id slab
    # [base, base+n_merged), ascending in cluster order. (The reference
    # allocates top-down so the root lands at 0, `Ploc++Kernel.h:311`;
    # bottom-up lets every round know its slab base from a running count —
    # ids are flipped once at the end.) Contiguity lets the emission be a
    # blended dynamic slice write instead of a row scatter.
    slab_start = base
    new_id = slab_start + rank

    # emit merged nodes: compact rows to the front (stable sort keeps rank
    # order), then blend the slab into the (over-allocated) i32 nodes
    # buffer (float payloads ride as i32 bits; never the other way round —
    # int bits in f32 rows are denormals, which fusions may flush)
    emit = lax.sort(
        tuple(
            [(~merge).astype(U32), cnode, rnode] + [as_i(u) for u in ucols]
        ),
        num_keys=1,
        is_stable=True,
    )
    rows = jnp.stack(emit[1:], axis=0)  # [8, size], merged rows first
    start = jnp.maximum(slab_start, 0)
    window = lax.dynamic_slice(nodes, (0, start), (8, size))
    j = jnp.arange(size, dtype=I32)
    window = jnp.where((j < n_merged)[None, :], rows, window)
    nodes = lax.dynamic_update_slice(nodes, window, (0, start))

    # survivors: merged cluster replaces its left partner
    cnode = jnp.where(merge, new_id, jnp.where(valid & ~dropped, cnode, INVALID))
    out_cols = [
        jnp.where(merge, u, jnp.where(valid & ~dropped, c, _BIG))
        for u, c in zip(ucols, cols)
    ]

    # compact with one stable sort on the keep flag
    keep = valid & ~dropped
    key = (~keep).astype(U32)
    sorted_ops = lax.sort(
        tuple([key, cnode, ccode] + out_cols), num_keys=1, is_stable=True
    )
    cnode = sorted_ops[1]
    ccode = sorted_ops[2]
    cols = list(sorted_ops[3:9])
    mat = jnp.stack(
        [as_i(c) for c in cols] + [ccode.astype(I32), cnode], axis=0
    )

    shift_bits = jnp.minimum(shift_bits + shift_step, 32)
    n_clusters = n_clusters - n_merged
    return (n_clusters, shift_bits, mat, nodes)


def ploc_build_topology(
    leaf_min, leaf_max, codes, hploc: bool = False, radius: int = PLOC_RADIUS,
    shift0: int = 3, shift_step: int = 3,
):
    """Row-major wrapper over `ploc_build_topology_packed`.

    leaf_min/max: f32[n,3] sorted leaf AABBs; codes: u32[n] sorted Morton
    codes (used only by the HPLOC segment schedule).
    Returns (left i32[n-1], right i32[n-1], node_min f32[n-1,3],
    node_max f32[n-1,3]) — root = 0.
    """
    packed_t = jnp.concatenate([leaf_min, -leaf_max], axis=1).T
    left, right, int_packed_t = ploc_build_topology_packed(
        packed_t, codes, hploc=hploc, radius=radius,
        shift0=shift0, shift_step=shift_step,
    )
    out = int_packed_t.T
    return left, right, out[:, :3], -out[:, 3:]


def ploc_build_topology_packed(
    leaf_packed_t, codes, hploc: bool = False, radius: int = PLOC_RADIUS,
    shift0: int = 3, shift_step: int = 3,
):
    """Agglomerate Morton-sorted leaves into a BVH2 topology, lane-major.

    leaf_packed_t: f32[6, n] (rows = min xyz, -max xyz) in sorted order.
    Returns (left i32[n-1], right i32[n-1], int_packed_t f32[6, n-1]) —
    root = 0.
    """
    n = leaf_packed_t.shape[1]
    n_internal = n - 1
    init_nodes = jnp.arange(n, dtype=I32) + n_internal  # leaf ids
    shift0 = jnp.asarray(shift0 if hploc else 32, I32)
    as_i = lambda x: lax.bitcast_convert_type(x, I32)

    mat = jnp.concatenate(
        [
            as_i(leaf_packed_t),
            codes.astype(I32)[None, :],
            init_nodes[None, :],
        ],
        axis=0,
    )  # i32[8, n]
    # packed emit buffer (lane-major), sized so the slab window of every
    # stage stays in bounds: a stage of width S starts writing at
    # n - nc <= n - S_next, and S - S_next < n
    nodes = jnp.zeros((8, n_internal + n), I32)

    state = (jnp.asarray(n, I32), shift0, mat, nodes)
    size = n
    sizes = []
    while size > _MIN_STAGE:
        sizes.append(size)
        size = max(_MIN_STAGE, ((int(size / _STAGE_RATIO) + 127) // 128) * 128)
    sizes.append(size)

    for si, size in enumerate(sizes):
        target = sizes[si + 1] if si + 1 < len(sizes) else 1

        def cond(s, target=target):
            return s[0] > target

        def body(s):
            return _round(s, n, radius, shift_step)

        state = lax.while_loop(cond, body, state)
        if target > 1:
            (nc, sb, mat, nodes) = state
            state = (nc, sb, mat[:, :target], nodes)

    (_, _, _, nodes) = state
    # ids were allocated bottom-up (root = n_internal-1); flip to the
    # reference's root-at-0 numbering: column c -> n_internal-1-c (a lane
    # reverse) and every internal child reference v -> n_internal-1-v
    # (leaf references, v >= n_internal, stay)
    nodes = nodes[:, :n_internal][:, ::-1]
    as_f = lambda x: lax.bitcast_convert_type(x, jnp.float32)

    def remap(v):
        return jnp.where(v < n_internal, n_internal - 1 - v, v)

    left = remap(nodes[0])
    right = remap(nodes[1])
    return left, right, as_f(nodes[2:8])
