"""LBVH radix-tree topology without atomics.

Two builders over the same (unique) radix tree on Morton-sorted keys:

* `karras_topology` — vectorized re-expression of Karras 2012
  (`src/TwoPassLbvhKernel.h:42-216`): per-internal-node
  direction + doubling range expansion + two binary searches, all as
  fixed-trip-count unrolled loops over the whole node array (data-parallel
  gathers, no divergence).

* `apetrei_topology` — the single-pass (Apetrei) construction
  (`src/SinglePassLbvhKernel.h:56-126`) re-derived without
  atomics: the radix tree is the max-Cartesian tree of the adjacent-key
  similarity array, each internal node lives at its own split boundary, and
  its leaf range follows from previous/next-smaller-value queries answered by
  a sparse-table descent. Parent links then follow from one comparison per
  node — the reference's racy "second arrival wins" climb disappears
  entirely.

Both produce identical trees (the radix tree over distinct keys is unique;
the reference's identical SAH costs for its two LBVH builders confirm the
same), with different internal-node index layouts, matching the reference's
two layouts.

Key tie-break: delta(i, j) = 32 + clz32(i ^ j) when codes are equal, else
clz32(code_i ^ code_j); out-of-range j gives -1 — exactly
`countCommonPrefixBits` (`TwoPassLbvhKernel.h:27-40`, note the ~0ull -> int
truncation that makes the out-of-range sentinel -1).
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax import lax

I32 = jnp.int32
U32 = jnp.uint32
V = 64  # threshold lanes: remapped deltas of <= 30-bit codes lie in [0, 52]
_BIG = 2**31 - 1


def _clz32(x):
    return lax.clz(x.astype(U32)).astype(I32)


def delta_at(codes, i, j):
    """Common-prefix length between sorted keys i and j with index
    augmentation on code ties; -1 where j is out of range. i, j: i32 arrays.
    """
    n = codes.shape[0]
    valid = (j >= 0) & (j < n)
    jc = jnp.clip(j, 0, n - 1)
    ci = codes[i]
    cj = codes[jc]
    x = ci ^ cj
    tie = 32 + _clz32(i.astype(U32) ^ jc.astype(U32))
    d = jnp.where(x == 0, tie, _clz32(x))
    return jnp.where(valid, d, -1)


def adjacent_deltas(codes):
    """delta(j, j+1) for j in [0, n-2] (the boundary similarity array).
    Pure slicing, no gathers."""
    n = codes.shape[0]
    ci = codes[:-1]
    cj = codes[1:]
    j = jnp.arange(n - 1, dtype=I32)
    x = ci ^ cj
    tie = 32 + _clz32(j.astype(U32) ^ (j + 1).astype(U32))
    return jnp.where(x == 0, tie, _clz32(x))


def _search_iters(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2)))) + 2


def karras_topology(codes):
    """Vectorized Karras build. codes: u32[n] sorted (with index tie-break
    semantics). Returns (left i32[2n-1], right i32[2n-1], parent i32[2n-1],
    first i32[n-1], last i32[n-1]).

    Node layout (`TwoPassLbvhKernel.h:196-216`): internal node i's children
    are node `split` (or leaf split) and node `split+1` (or leaf split+1);
    leaves are biased by n_internal. Root is internal node 0.
    """
    n = codes.shape[0]
    n_internal = n - 1
    iters = _search_iters(n)
    idx = jnp.arange(n_internal, dtype=I32)

    l_delta = delta_at(codes, idx, idx - 1)
    r_delta = delta_at(codes, idx, idx + 1)
    d = jnp.where(r_delta > l_delta, I32(1), I32(-1))
    delta_min = jnp.minimum(l_delta, r_delta)

    # Doubling upper bound for the range length (TwoPassLbvhKernel.h:57-74).
    lmax = jnp.full_like(idx, 2)
    growing = jnp.ones_like(idx, dtype=bool)
    for _ in range(iters):
        probe = delta_at(codes, idx, idx + d * lmax)
        growing = growing & (probe > delta_min)
        lmax = jnp.where(growing, lmax << 1, lmax)

    # Binary search for the far end (TwoPassLbvhKernel.h:76-92).
    l = jnp.zeros_like(idx)
    for k in range(1, iters + 1):
        t = lmax >> k
        probe = delta_at(codes, idx, idx + (l + t) * d)
        l = jnp.where((t > 0) & (probe > delta_min), l + t, l)

    jdx = idx + l * d
    first = jnp.minimum(idx, jdx)
    last = jnp.maximum(idx, jdx)

    # findSplit (TwoPassLbvhKernel.h:102-130): do-while binary search with the
    # exact same trip semantics (body runs once more after stride hits 1).
    delta_node = delta_at(codes, first, last)
    split = first
    stride = last - first
    active = jnp.ones_like(idx, dtype=bool)
    for _ in range(iters):
        stride = (stride + 1) >> 1
        middle = split + stride
        probe = delta_at(codes, first, middle)
        take = active & (middle < last) & (probe > delta_node)
        split = jnp.where(take, middle, split)
        active = active & (stride > 1)

    left = jnp.where(split == first, split + n_internal, split)
    right = jnp.where(split + 1 == last, split + 1 + n_internal, split + 1)

    n_nodes = 2 * n - 1
    left_full = jnp.full((n_nodes,), -1, I32).at[:n_internal].set(left)
    right_full = jnp.full((n_nodes,), -1, I32).at[:n_internal].set(right)
    parent = jnp.full((n_nodes,), -1, I32)
    parent = parent.at[left].set(idx)
    parent = parent.at[right].set(idx)
    return left_full, right_full, parent, first, last


def _sparse_min_tables(vals, levels: int):
    """T_k[i] = min(vals[i : i + 2^k]) with clamped windows."""
    n = vals.shape[0]
    tabs = [vals]
    cur = vals
    pos = jnp.arange(n, dtype=I32)
    for k in range(1, levels + 1):
        shift = 1 << (k - 1)
        cur = jnp.minimum(cur, cur[jnp.minimum(pos + shift, n - 1)])
        tabs.append(cur)
    return tabs


def _next_smaller(tabs, vals):
    """NSV(i) = least j > i with vals[j] < vals[i] via sparse-table descent;
    n (==len) where none exists."""
    n = vals.shape[0]
    pos = jnp.arange(n, dtype=I32) + 1  # candidate start
    levels = len(tabs) - 1
    for k in range(levels, -1, -1):
        width = 1 << k
        # window [pos, pos+width) entirely >= vals[i] -> skip it
        safe_pos = jnp.minimum(pos, n - 1)
        win_min = tabs[k][safe_pos]
        in_range = pos + width <= n
        skip = in_range & (win_min >= vals)
        pos = jnp.where(skip, pos + width, pos)
    # pos is the first j with vals[j] < vals[i], or >= n
    return pos


def nsv_psv(vals):
    """Next/previous strictly-smaller-value indices for each position.
    Returns (psv i32[n] in [-1, n-1], nsv i32[n] in [1, n])."""
    n = vals.shape[0]
    levels = max(1, math.ceil(math.log2(max(n, 2))))
    tabs = _sparse_min_tables(vals, levels)
    nsv = _next_smaller(tabs, vals)
    rev = vals[::-1]
    tabs_r = _sparse_min_tables(rev, levels)
    nsv_r = _next_smaller(tabs_r, rev)
    psv = (n - 1) - nsv_r[::-1]  # maps reversed NSV back; -1 where none
    return psv, nsv


def apetrei_topology_fast(codes):
    """Gather-free single-pass topology via threshold scans.

    The sparse-table NSV/PSV descent of `apetrei_topology` is re-expressed over
    the *small alphabet* of delta values: with 30-bit codes and n <= 2^22
    leaves, delta(j) takes at most 64 distinct values, so

        nsv(i) = first j > i with delta(j) < delta(i)

    becomes, for every threshold v at once, an exclusive suffix-min of
    position-packed keys over a [V, n-1] mask table — pure `lax.cummin`
    rows — followed by a one-hot row select at v = delta(i). Positions and
    delta values are packed as pos*64+delta so a single min carries both
    (the same monotone-packing trick the reference uses for its PLOC
    neighbor encoding, `Ploc++Kernel.h:140-146`). Child links are emitted
    without scatters: every non-root node is sorted by (parent, side) and
    children of node k land exactly at slots 2k/2k+1.

    Same output contract as `apetrei_topology`.
    """
    n = codes.shape[0]
    m = n - 1
    dlt, first, last, psv_val, nsv_val, psv = _threshold_core(codes)
    nsv = last
    idx = jnp.arange(m, dtype=I32)
    is_root = (first == 0) & (last == n - 1)
    internal_is_right = psv_val > nsv_val
    parent_internal = jnp.where(is_root, I32(-1), jnp.where(internal_is_right, psv, nsv))

    jdx = jnp.arange(n, dtype=I32)
    ldl = jnp.concatenate([jnp.full((1,), -1, I32), dlt])  # dlt[j-1]
    ldr = jnp.concatenate([dlt, jnp.full((1,), -1, I32)])  # dlt[j]
    leaf_is_right = ldl > ldr
    parent_leaf = jnp.where(leaf_is_right, jdx - 1, jdx)

    # child links by sorting (side, parent): left children land in the
    # first m sorted slots, right children in the next m
    key_internal = jnp.where(
        is_root, I32(2 * m), internal_is_right.astype(I32) * m + parent_internal
    )
    key_leaf = leaf_is_right.astype(I32) * m + parent_leaf
    all_keys = jnp.concatenate([key_internal, key_leaf]).astype(jnp.uint32)
    all_vals = jnp.concatenate([idx, m + jdx])
    _, sorted_vals = lax.sort_key_val(all_keys, all_vals)
    left_internal = sorted_vals[:m]
    right_internal = sorted_vals[m : 2 * m]

    n_nodes = 2 * n - 1
    left = jnp.concatenate([left_internal, jnp.full((n,), -1, I32)])
    right = jnp.concatenate([right_internal, jnp.full((n,), -1, I32)])
    parent = jnp.concatenate([parent_internal, parent_leaf])
    root_idx = jnp.argmax(is_root).astype(I32)
    return left, right, parent, first, last, root_idx


def _threshold_core(codes):
    """Shared threshold-scan core: per-boundary (first, last, psv_val,
    nsv_val, psv, nsv) without gathers. See `apetrei_topology_fast`.

    Layout: [m, V] with the V=64 threshold lanes minor (deltas of <=30-bit
    codes remap to a dense [0,52] alphabet; lanes pad to 64).
    """
    n = codes.shape[0]
    m = n - 1
    assert n <= (1 << 22), "pos*64 packing requires n <= 2^22"
    dlt = remap_deltas(adjacent_deltas(codes))
    psv_packed, nsv_packed = psv_nsv_packed(dlt)

    has_nsv = nsv_packed != _BIG
    has_psv = psv_packed >= 0
    nsv = jnp.where(has_nsv, nsv_packed >> 6, m)
    nsv_val = jnp.where(has_nsv, nsv_packed & 63, -1)
    psv = jnp.where(has_psv, psv_packed >> 6, -1)
    psv_val = jnp.where(has_psv, psv_packed & 63, -1)
    return dlt, psv + 1, nsv, psv_val, nsv_val, psv


def remap_deltas(dlt_raw):
    """Order-preserving remap of adjacent deltas onto [0, 52]: normal
    prefixes [2, 31] -> [0, 29], index tie-breaks [41, 63] -> [30, 52]."""
    return jnp.where(dlt_raw <= 31, dlt_raw - 2, dlt_raw - 11)


def _threshold_planes(dlt):
    """Exclusive [m, V] prefix-max / suffix-min planes of position-packed
    keys (pos*64 + dlt) masked to the boundaries with dlt < v, and the
    one-hot selector of each row's own lane v = dlt."""
    m = dlt.shape[0]
    packed = jnp.arange(m, dtype=I32) * 64 + dlt
    vr = jnp.arange(V, dtype=I32)
    maskv = dlt[:, None] < vr[None, :]
    suf = lax.cummin(jnp.where(maskv, packed[:, None], _BIG), axis=0, reverse=True)
    nsv_rows = jnp.concatenate([suf[1:], jnp.full((1, V), _BIG, I32)], axis=0)
    pre = lax.cummax(jnp.where(maskv, packed[:, None], I32(-1)), axis=0)
    psv_rows = jnp.concatenate([jnp.full((1, V), -1, I32), pre[:-1]], axis=0)
    return psv_rows, nsv_rows, dlt[:, None] == vr[None, :]


def psv_nsv_packed(dlt):
    """(psv_packed, nsv_packed) for remapped deltas i32[m] in [0, 63]:
    psv(i) = max_{j<i, d_j<d_i} (j*64 + d_j), -1 where none;
    nsv(i) = min_{j>i, d_j<d_i} (j*64 + d_j), 2^31-1 where none."""
    psv_rows, nsv_rows, onehot = _threshold_planes(dlt)
    nsv = jnp.sum(jnp.where(onehot, nsv_rows, 0), axis=1)
    psv = jnp.sum(jnp.where(onehot, psv_rows, 0), axis=1)
    return psv, nsv


def psv_nsv_payload(dlt, pay):
    """`psv_nsv_packed` plus an i32 payload evaluated at each position:
    (psv_packed, pay[psv], nsv_packed, pay[nsv]); payload -1 where no
    smaller value exists."""
    m = dlt.shape[0]
    psv, nsv = psv_nsv_packed(dlt)
    np_ = jnp.where(nsv != _BIG, pay[jnp.clip(nsv >> 6, 0, m - 1)], -1)
    pp_ = jnp.where(psv >= 0, pay[jnp.clip(psv >> 6, 0, m - 1)], -1)
    return psv, pp_, nsv, np_


def child_positions(psv, nsv):
    """(left i32[m], right i32[m]): boundary index of each node's internal
    child, -1 where the child is a leaf.

    Node k covers [psv(k)+1, nsv(k)] and splits at its own boundary k, so
    its left child is the argmin of dlt over (psv(k), k) and its right
    child the argmin over (k, nsv(k)). For sorted keys range minima are
    unique (two boundaries with equal delta and nothing smaller between
    them would need the same bit to flip 0->1 twice in an ascending
    sequence), so every boundary j with nsv(j) == k lies in (psv(k), k)
    and the one with the smallest index has the smallest delta: the left
    child is min{j : nsv(j) == k}, and mirrored, the right child is
    max{j : psv(j) == k}. Min/max scatters are order-independent, so the
    result is deterministic."""
    m = psv.shape[0]
    j = jnp.arange(m, dtype=I32)
    left = jnp.full((m,), m, I32).at[nsv].min(j, mode="drop")  # nsv == m: none
    right = jnp.full((m,), -1, I32).at[jnp.where(psv >= 0, psv, m)].max(
        j, mode="drop"
    )
    return jnp.where(left < m, left, -1), right


def _karras_parent_kp(codes, dlt, first, last, psv, nsv, psv_val, nsv_val, is_root):
    """Karras index of every node's parent.

    pi (the apetrei->karras relabel) is known densely; pi[parent] is
    "pi evaluated at my psv/nsv position" (`psv_nsv_payload`).
    Returns (kp_internal i32[m], kp_leaf i32[n], internal_is_right,
    leaf_is_right, pi)."""
    n = codes.shape[0]
    m = n - 1
    internal_is_right = psv_val > nsv_val
    pi = jnp.where(is_root, 0, jnp.where(internal_is_right, first, last))

    _, pi_at_psv, _, pi_at_nsv = psv_nsv_payload(dlt, pi)
    kp_internal = jnp.where(internal_is_right, pi_at_psv, pi_at_nsv)

    jdx = jnp.arange(n, dtype=I32)
    ldl = jnp.concatenate([jnp.full((1,), -1, I32), dlt])
    ldr = jnp.concatenate([dlt, jnp.full((1,), -1, I32)])
    leaf_is_right = ldl > ldr
    # leaf j's parent is boundary j-1 (right child) or j (left child) —
    # both dense shifts of pi
    pi_at_j = jnp.concatenate([pi, pi[-1:]])  # pi[min(j, m-1)]
    pi_at_jm1 = jnp.concatenate([pi[:1], pi])[:n]  # pi[max(j-1, 0)]
    kp_leaf = jnp.where(leaf_is_right, pi_at_jm1, pi_at_j)
    return kp_internal, kp_leaf, internal_is_right, leaf_is_right, pi


def karras_topology_fast(codes):
    """Karras node layout emitted by the gather-free threshold-scan core.

    The Karras kernel stores the node covering [l, r] at index `split` when
    it is a left child and `split+1` when it is a right child
    (`TwoPassLbvhKernel.h:210-211`) — i.e. at its own `last` (left child)
    or `first` (right child), root at 0. Relabeling the split-position
    (Apetrei) topology with that bijection reproduces Karras's arrays
    exactly, at threshold-scan cost instead of per-node binary-search
    gathers. Returns the same contract as `karras_topology` (root == 0).
    """
    n = codes.shape[0]
    m = n - 1
    dlt, first, last, psv_val, nsv_val, psv = _threshold_core(codes)
    nsv = last
    is_root = (first == 0) & (last == n - 1)
    kp_internal, kp_leaf, internal_is_right, leaf_is_right, pi = (
        _karras_parent_kp(
            codes, dlt, first, last, psv, nsv, psv_val, nsv_val, is_root
        )
    )

    jdx = jnp.arange(n, dtype=I32)
    key_internal = jnp.where(
        is_root, I32(2 * m), internal_is_right.astype(I32) * m + kp_internal
    )
    key_leaf = leaf_is_right.astype(I32) * m + kp_leaf
    all_keys = jnp.concatenate([key_internal, key_leaf]).astype(jnp.uint32)
    all_vals = jnp.concatenate([pi, m + jdx])
    _, sorted_vals = lax.sort_key_val(all_keys, all_vals)
    left_internal = sorted_vals[:m]
    right_internal = sorted_vals[m : 2 * m]

    # permute (first, last, parent) into karras node order with one sort
    parent_internal_k = jnp.where(is_root, I32(-1), kp_internal)
    _, first_k, last_k, parent_k = lax.sort(
        (pi.astype(jnp.uint32), first, last, parent_internal_k), num_keys=1
    )

    n_nodes = 2 * n - 1
    left = jnp.concatenate([left_internal, jnp.full((n,), -1, I32)])
    right = jnp.concatenate([right_internal, jnp.full((n,), -1, I32)])
    parent = jnp.concatenate([parent_k, kp_leaf])
    return left, right, parent, first_k, last_k


def _topology_scans(codes):
    """Topology scans: (dlt, first, last, psv_val, nsv_val, psv, lc, rc)
    from the V=64 threshold planes plus the child positions."""
    dlt, first, last, psv_val, nsv_val, psv = _threshold_core(codes)
    lc, rc = child_positions(psv, last)
    return dlt, first, last, psv_val, nsv_val, psv, lc, rc


def apetrei_build_packed(codes, leaf_packed_t):
    """Fused single-pass build: threshold-scan topology + anchored refit,
    all in lane-major packed-AABB form.

    The production path behind `models.lbvh.build_single_pass`: one
    threshold-core evaluation feeds both the topology emission and the
    boundary-ordered anchored refit (node i's range contains boundary i, so
    most AABBs resolve with dense shifts — see `refit.refit_anchored_packed`).
    Child links come from `child_positions` — node k's internal child is
    the delta argmin of each half-range, so no (side, parent) inversion
    sort is needed at all.

    leaf_packed_t: f32[6, n] (rows = leaf min xyz, -max xyz), sorted order.
    Returns (left, right, parent, int_packed_t f32[6, m], root).
    """
    from . import refit as _refit

    n = codes.shape[0]
    m = n - 1
    dlt, first, last, psv_val, nsv_val, psv, lc, rc = _topology_scans(codes)
    nsv = last
    idx = jnp.arange(m, dtype=I32)
    is_root = (first == 0) & (last == n - 1)
    internal_is_right = psv_val > nsv_val
    parent_internal = jnp.where(is_root, I32(-1), jnp.where(internal_is_right, psv, nsv))

    int_packed_t = _refit.refit_anchored_packed(leaf_packed_t, first, last)

    jdx = jnp.arange(n, dtype=I32)
    ldl = jnp.concatenate([jnp.full((1,), -1, I32), dlt])
    ldr = jnp.concatenate([dlt, jnp.full((1,), -1, I32)])
    leaf_is_right = ldl > ldr
    parent_leaf = jnp.where(leaf_is_right, jdx - 1, jdx)

    left_internal = jnp.where(lc >= 0, lc, m + idx)
    right_internal = jnp.where(rc >= 0, rc, m + idx + 1)

    left = jnp.concatenate([left_internal, jnp.full((n,), -1, I32)])
    right = jnp.concatenate([right_internal, jnp.full((n,), -1, I32)])
    parent = jnp.concatenate([parent_internal, parent_leaf])
    root_idx = jnp.argmax(is_root).astype(I32)
    return left, right, parent, int_packed_t, root_idx


def apetrei_build(codes, leaf_min, leaf_max):
    """Row-major wrapper around `apetrei_build_packed`.
    Returns (left, right, parent, int_min, int_max, root)."""
    leaf_packed_t = jnp.concatenate([leaf_min, -leaf_max], axis=1).T
    left, right, parent, int_packed_t, root = apetrei_build_packed(
        codes, leaf_packed_t
    )
    out = int_packed_t.T
    return left, right, parent, out[:, :3], -out[:, 3:], root


def karras_build_packed(codes, leaf_packed_t):
    """Fused two-pass build: scan topology + anchored refit + ONE
    single-key relabel sort. Lane-major packed-AABB form.

    The Karras relabel of a node's CHILDREN is local: boundary node i
    splits its range at boundary i, and Karras indexes children by the
    split position (`TwoPassLbvhKernel.h:196-216` stores children at
    gamma / gamma+1), so

      left  child = lc >= 0 ? karras node i     : leaf i    (m + i)
      right child = rc >= 0 ? karras node i + 1 : leaf i+1  (m + i + 1)

    No parent->child inversion sort and no payload-carrying scan pass are
    needed at all. Everything is permuted into Karras order by one
    single-key unstable sort on pi (pi[j] = right-child ? first : last,
    root -> 0; unique), with children + AABB rows as payload.

    leaf_packed_t: f32[6, n] (rows = min xyz, -max xyz), sorted order.
    Returns (left, right, int_packed_t f32[6, m]); root is node 0.
    """
    from . import refit as _refit

    n = codes.shape[0]
    m = n - 1
    dlt, first, last, psv_val, nsv_val, psv, lc, rc = _topology_scans(codes)
    idx = jnp.arange(m, dtype=I32)
    is_root = (first == 0) & (last == n - 1)
    internal_is_right = psv_val > nsv_val
    pi = jnp.where(is_root, 0, jnp.where(internal_is_right, first, last))

    left_k = jnp.where(lc >= 0, idx, m + idx)
    right_k = jnp.where(rc >= 0, idx + 1, m + idx + 1)

    int_b = _refit.refit_anchored_packed(leaf_packed_t, first, last)

    (_, l_s, r_s, a0, a1, a2, b0, b1, b2) = lax.sort(
        (
            pi.astype(jnp.uint32),
            left_k, right_k,
            int_b[0], int_b[1], int_b[2], int_b[3], int_b[4], int_b[5],
        ),
        num_keys=1,
        is_stable=False,
    )
    int_packed_t = jnp.stack([a0, a1, a2, b0, b1, b2], axis=0)

    left = jnp.concatenate([l_s, jnp.full((n,), -1, I32)])
    right = jnp.concatenate([r_s, jnp.full((n,), -1, I32)])
    return left, right, int_packed_t


def karras_build(codes, leaf_min, leaf_max):
    """Row-major wrapper around `karras_build_packed`.
    Returns (left, right, int_min, int_max); root is node 0."""
    leaf_packed_t = jnp.concatenate([leaf_min, -leaf_max], axis=1).T
    left, right, int_packed_t = karras_build_packed(codes, leaf_packed_t)
    out = int_packed_t.T
    return left, right, out[:, :3], -out[:, 3:]


def apetrei_topology(codes):
    """Single-pass-style build: every node's parent computed directly.

    Internal node i sits at boundary i (between sorted leaves i and i+1) and
    covers leaves [psv(i)+1, nsv(i)] of the adjacent-delta array; its parent
    is whichever external boundary has the longer common prefix — the exact
    relation Apetrei's climbing kernel discovers via atomics
    (`SinglePassLbvhKernel.h:64-126`), computed here in closed form.

    Returns (left, right, parent, first, last, root_idx).
    """
    n = codes.shape[0]
    n_internal = n - 1
    dlt = adjacent_deltas(codes)

    psv, nsv = nsv_psv(dlt)
    # Boundary j sits between leaves j and j+1. Node i's external boundaries
    # are psv(i) and nsv(i); its leaf range is therefore [psv+1, nsv]. nsv of
    # n-1 (== len(dlt), no smaller boundary to the right) already equals the
    # last leaf index, so no correction is needed on either side.
    first = psv + 1
    last = nsv

    idx = jnp.arange(n_internal, dtype=I32)
    # Parent boundary: the external boundary with larger delta (longer common
    # prefix). Out-of-range boundaries get -1 so the comparison never picks
    # them; the root has both external deltas == -1.
    left_b = first - 1
    right_b = last
    dl = jnp.where(left_b >= 0, dlt[jnp.maximum(left_b, 0)], -1)
    dr = jnp.where(right_b <= n_internal - 1, dlt[jnp.minimum(right_b, n_internal - 1)], -1)
    parent_of_internal = jnp.where(dl > dr, left_b, right_b)
    is_root = (first == 0) & (last == n - 1)
    parent_of_internal = jnp.where(is_root, I32(-1), parent_of_internal)
    internal_is_right_child = dl > dr  # attached at left external boundary

    # Leaves: leaf j covers [j, j]; external boundaries j-1 and j.
    jdx = jnp.arange(n, dtype=I32)
    ldl = jnp.where(jdx - 1 >= 0, dlt[jnp.maximum(jdx - 1, 0)], -1)
    ldr = jnp.where(jdx <= n_internal - 1, dlt[jnp.minimum(jdx, n_internal - 1)], -1)
    parent_of_leaf = jnp.where(ldl > ldr, jdx - 1, jdx)
    leaf_is_right_child = ldl > ldr

    n_nodes = 2 * n - 1
    parent = jnp.full((n_nodes,), -1, I32)
    parent = parent.at[idx].set(parent_of_internal)
    parent = parent.at[n_internal + jdx].set(parent_of_leaf)

    # Scatter child links. Each parent receives exactly one left and one
    # right child, so plain scatters are race-free; entries that don't apply
    # are routed out of bounds and dropped.
    left = jnp.full((n_nodes,), -1, I32)
    right = jnp.full((n_nodes,), -1, I32)
    oob = I32(n_nodes)
    tgt_i = jnp.where(is_root, oob, parent_of_internal)
    left = left.at[jnp.where(internal_is_right_child, oob, tgt_i)].set(
        idx, mode="drop"
    )
    right = right.at[jnp.where(internal_is_right_child, tgt_i, oob)].set(
        idx, mode="drop"
    )
    left = left.at[jnp.where(leaf_is_right_child, oob, parent_of_leaf)].set(
        n_internal + jdx, mode="drop"
    )
    right = right.at[jnp.where(leaf_is_right_child, parent_of_leaf, oob)].set(
        n_internal + jdx, mode="drop"
    )

    root_idx = jnp.argmax(is_root).astype(I32)
    return left, right, parent, first, last, root_idx
