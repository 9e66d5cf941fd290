"""BVH2 -> BVH4 collapse, derived analytically (no task queue at all).

Not the production path (that is the slab BFS in `collapse.py`): its
pointer-doubling trips are full-array gathers and its emit is [n,4,3]
scatters. It is kept as an executable specification of the collapse
derived without a task queue.

The reference runs a persistent kernel spinning on a global task queue with
atomic slot allocation (`src/TwoPassLbvhKernel.h:237-337`);
the CPU oracle (`Utility.cpp:540-611`) is the same algorithm sequentially:
pop a task, expand the largest-area internal child twice (<= 4 children),
enqueue internal children.

Key observation: the queue is unnecessary. A task's expansion is a purely
LOCAL function of its children's and grandchildren's areas, so the entire
wide tree is computable in closed form:

1. **Expansion tables** — for EVERY internal bvh2 node X simultaneously,
   simulate the two expansion steps (vectorized over [n_int, 4] slot
   arrays): final child ids `ids[X, :4]`, `count[X]`, and the two consumed
   nodes `e1[X]`, `e2[X]`. Same argmax/tie/area>0 semantics as the oracle.
2. **State propagation** — each internal node is exactly one of WIDE (it
   becomes a wide node), E1 (consumed as some wide ancestor's first
   expansion) or E2 (second expansion). The state of Y is a function of the
   state of parent(Y) plus local e1/e2 equality tests; consumption chains
   have length <= 2 (E1's child may be E2; E2's children are always WIDE),
   so the transition is a 3-state table per node. Tables compose
   associatively along parent chains -> **pointer doubling** resolves all
   states in O(log depth) converging `while_loop` trips.
3. **BFS numbering** — the oracle numbers wide nodes in BFS queue order,
   which is exactly lexicographic (level, slot-path-from-root). Each wide
   node's wide-parent A(Y) and slot within A are local lookups; level and
   the path bit-string (2 bits per level, left-aligned into 4 u32 words =
   depth <= 64, enough for any radix tree over 62-bit keys) accumulate by a
   second pointer-doubling pass over the A-chain. One multi-key
   `lax.sort` then yields the exact oracle numbering, byte-for-byte.
4. **Emit** — one masked scatter per output array.

Everything is flat gathers/scatters over [n_int]-sized arrays plus three
short converging loops — no per-level traffic, no task queue.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..types import Bvh2, Bvh4

I32 = jnp.int32
U32 = jnp.uint32
INVALID = jnp.int32(-1)

_WIDE, _E1, _E2 = 0, 1, 2
_MAX_WIDE_DEPTH = 64  # 4 u32 path words x 16 levels; radix trees are <= 63 deep


def _apply(table, s):
    """Apply a base-4-encoded 3-state transition table to state(s) s."""
    return (table >> (2 * s)) & 3


@jax.jit
def collapse_bvh2_to_bvh4_analytic(bvh: Bvh2) -> Bvh4:
    n_leaves = bvh.n_leaves
    n_int = bvh.n_internal
    mm = bvh.n_nodes
    cap = max(n_int, 1)
    root = bvh.root.astype(I32)

    pk = bvh.packed_t  # f32[6, M] (min xyz, -max xyz)
    left = bvh.left.astype(I32)
    right = bvh.right.astype(I32)
    ext = jnp.maximum(-pk[3:6] - pk[0:3], 0.0)
    area = 2.0 * (ext[0] * ext[1] + ext[0] * ext[2] + ext[1] * ext[2])

    # ---- 1. per-node expansion simulation (all internal nodes at once) ----
    slot_ids = jnp.arange(4, dtype=I32)[None, :]
    ids = jnp.stack(
        [left[:cap], right[:cap],
         jnp.full((cap,), INVALID), jnp.full((cap,), INVALID)], axis=1
    )
    count = jnp.full((cap,), 2, I32)
    e_steps = []
    for _ in range(2):
        is_int = (ids >= 0) & (ids < n_int)
        a = jnp.where(is_int, area[jnp.clip(ids, 0, mm - 1)], -1.0)
        pos = jnp.argmax(a, axis=1).astype(I32)  # first max, like the oracle
        best = jnp.max(a, axis=1)
        do = best > 0  # oracle: `area(c) > 0.0` strictly
        chosen = jnp.take_along_axis(ids, pos[:, None], axis=1)[:, 0]
        csafe = jnp.clip(chosen, 0, mm - 1)
        cl = left[csafe]
        cr = right[csafe]
        onehot = slot_ids == pos[:, None]
        ids = jnp.where(do[:, None] & onehot, cl[:, None], ids)
        ids = jnp.where(
            do[:, None] & (slot_ids == count[:, None]), cr[:, None], ids
        )
        e_steps.append(jnp.where(do, chosen, INVALID))
        count = count + do.astype(I32)
    e1, e2 = e_steps

    # ---- 2. states via transition-table pointer doubling ----
    # parent of every node (leaf or internal); -1 = no parent (root/orphan)
    src = jnp.arange(cap, dtype=I32)
    parent2 = jnp.full((mm,), INVALID)
    parent2 = parent2.at[jnp.clip(left[:cap], 0, mm - 1)].set(src)
    parent2 = parent2.at[jnp.clip(right[:cap], 0, mm - 1)].set(src)
    if n_int == 0:  # degenerate single-leaf scene: no internal nodes
        parent2 = jnp.full((mm,), INVALID)

    y = src
    p = parent2[:cap]
    ps = jnp.clip(p, 0, cap - 1)
    g = parent2[ps]
    gs = jnp.clip(g, 0, cap - 1)
    # T_Y(WIDE): consumed if Y is parent's first/second expansion pick
    t_wide = jnp.where(y == e1[ps], _E1, jnp.where(y == e2[ps], _E2, _WIDE))
    # T_Y(E1): parent was grandparent's first pick; Y consumed iff second pick
    t_e1 = jnp.where(y == e2[gs], _E2, _WIDE)
    # T_Y(E2) = WIDE always
    fenc = t_wide | (t_e1 << 2)
    parentless = p < 0  # root, plus any orphan slot (self-loop => converges)
    fenc = jnp.where(parentless, 0, fenc)  # constant-WIDE table
    ptr = jnp.where(parentless, y, p)

    def _states_body(carry):
        ptr, f, _ = carry
        fp = f[ptr]
        nf = (
            _apply(f, _apply(fp, 0))
            | (_apply(f, _apply(fp, 1)) << 2)
            | (_apply(f, _apply(fp, 2)) << 4)
        )
        nptr = ptr[ptr]
        return nptr, nf, jnp.any(nptr != ptr)

    ptr, fenc, _ = lax.while_loop(
        lambda c: c[2], _states_body,
        (ptr, fenc, jnp.asarray(n_int > 1)),
    )
    state = fenc & 3  # = F_Y(WIDE at root)
    reach = ptr == root  # orphan slots converge on themselves, not the root
    is_root = y == root
    is_wide = (state == _WIDE) & reach

    # ---- wide-parent A and slot index (local once states are known) ----
    # for ANY node (incl. leaves): the wide node whose final slots hold it
    p_all = parent2
    ps_all = jnp.clip(p_all, 0, cap - 1)
    g_all = parent2[ps_all]
    gs_all = jnp.clip(g_all, 0, cap - 1)
    s_p = state[ps_all]
    s_g = state[gs_all]
    a_of = jnp.where(
        s_p == _WIDE,
        p_all,
        jnp.where(
            s_p == _E1,
            g_all,
            # E2: consumed by its parent (direct child) or grandparent's parent
            jnp.where(s_g == _WIDE, g_all, parent2[gs_all]),
        ),
    )
    a_of = jnp.where(p_all < 0, INVALID, a_of)
    a_int = a_of[:cap]
    a_safe = jnp.clip(a_int, 0, cap - 1)
    slot_in_a = jnp.argmax(ids[a_safe] == y[:, None], axis=1).astype(I32)

    # ---- 3. level + path words by pointer doubling over the A-chain ----
    chain_live = is_wide & ~is_root
    a = jnp.where(chain_live, a_safe, root)
    lvl = jnp.where(chain_live, 1, 0).astype(I32)

    def _lvl_body(carry):
        a, d, _ = carry
        nd = d + d[a]
        na = a[a]
        return na, nd, jnp.any(na != a)

    a_fin, lvl, _ = lax.while_loop(
        lambda c: c[2], _lvl_body, (a, lvl, jnp.asarray(n_int > 1))
    )

    # path contribution: slot bits at position 2*(level-1) from the top of a
    # 128-bit string split into 4 u32 words (left-aligned => same-level
    # lexicographic compare is plain unsigned compare)
    li = jnp.maximum(lvl - 1, 0)
    word = li // 16
    shift = (30 - 2 * (li % 16)).astype(U32)
    bits = jnp.where(chain_live, slot_in_a.astype(U32) << shift, U32(0))
    words = [
        jnp.where(word == k, bits, U32(0)) for k in range(4)
    ]
    a = jnp.where(chain_live, a_safe, root)

    def _path_body(carry):
        a, w0, w1, w2, w3, _ = carry
        nw = (w0 | w0[a], w1 | w1[a], w2 | w2[a], w3 | w3[a])
        na = a[a]
        return (na, *nw, jnp.any(na != a))

    a, w0, w1, w2, w3, _ = lax.while_loop(
        lambda c: c[5], _path_body, (a, *words, jnp.asarray(n_int > 1))
    )

    # ---- BFS rank = position under ascending (level, path) sort ----
    lvl_key = jnp.where(is_wide, lvl.astype(U32), U32(0x7FFFFFFF))
    sorted_ops = lax.sort(
        (lvl_key, w0, w1, w2, w3, y), num_keys=5, is_stable=True
    )
    bfs_rank = jnp.zeros((cap,), I32).at[sorted_ops[5]].set(
        jnp.arange(cap, dtype=I32)
    )
    n_wide = jnp.sum(is_wide.astype(I32))

    # ---- 4. emit (one masked scatter per array) ----
    valid_slot = slot_ids < count[:, None]
    ids_safe = jnp.clip(ids, 0, mm - 1)
    child_vals = jnp.where(
        ~valid_slot,
        INVALID,
        jnp.where(
            ids >= n_int,
            cap + ids - n_int,
            bfs_rank[jnp.clip(ids, 0, cap - 1)],
        ),
    )
    cmin_vals = jnp.where(
        valid_slot[None], pk[0:3][:, ids_safe], 0.0
    ).transpose(1, 2, 0)
    cmax_vals = jnp.where(
        valid_slot[None], -pk[3:6][:, ids_safe], 0.0
    ).transpose(1, 2, 0)
    parent_vals = jnp.where(is_root, INVALID, bfs_rank[a_safe])

    tgt = jnp.where(is_wide, bfs_rank, cap)  # cap = out of range => dropped
    out_child = jnp.full((cap, 4), INVALID).at[tgt].set(
        child_vals, mode="drop"
    )
    out_cmin = jnp.zeros((cap, 4, 3)).at[tgt].set(cmin_vals, mode="drop")
    out_cmax = jnp.zeros((cap, 4, 3)).at[tgt].set(cmax_vals, mode="drop")
    out_parent = jnp.full((cap,), INVALID).at[tgt].set(
        parent_vals, mode="drop"
    )
    out_count = jnp.zeros((cap,), I32).at[tgt].set(count, mode="drop")

    leaf_prim = left[n_int:]
    leaf_parent = bfs_rank[jnp.clip(a_of[n_int:], 0, cap - 1)]

    return Bvh4.from_rowmajor(
        child_min=out_cmin,
        child_max=out_cmax,
        child=out_child,
        parent=out_parent,
        child_count=out_count,
        n_nodes=n_wide,
        leaf_prim=leaf_prim,
        leaf_parent=leaf_parent,
    )
