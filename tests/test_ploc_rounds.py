"""PLOC nearest-neighbour stage and merge rounds vs a numpy oracle.

The oracle is a direct reading of PLOC: every live cluster looks at the
clusters within +-radius in Morton order (same segment only), picks the
lexicographic minimum of (union area, index) — the reference's packed
`(area_bits << 32) | index` atomicMin order, `Ploc++Kernel.h:140-146` —
mutual pairs merge into the left partner, merged nodes get consecutive
bottom-up ids, and survivors stay in order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from jax_bvh.ops import ploc

I32 = jnp.int32


def _area(u):
    ex = np.float32(-u[3] - u[0])
    ey = np.float32(-u[4] - u[1])
    ez = np.float32(-u[5] - u[2])
    return np.float32(2.0) * np.float32(
        np.float32(ex * ey) + np.float32(ex * ez) + np.float32(ey * ez)
    )


def _nn_oracle(cols, seg, nc, radius):
    """-> (merge bool[S], dropped bool[S], partner i32[S]) for clusters in
    [0, nc)."""
    size = cols.shape[1]
    best = np.full(size, -1)
    for i in range(nc):
        cands = []
        for j in range(max(0, i - radius), min(nc, i + radius + 1)):
            if j != i and seg[j] == seg[i]:
                cands.append((_area(np.minimum(cols[:, i], cols[:, j])), j))
        if cands:
            best[i] = min(cands)[1]
    merge = np.zeros(size, bool)
    dropped = np.zeros(size, bool)
    for i in range(nc):
        j = best[i]
        if j >= 0 and best[j] == i:
            merge[i] = j > i
            dropped[i] = j < i
    return merge, dropped, best


def _seg(codes, shift):
    return np.zeros_like(codes) if shift >= 32 else codes >> np.uint32(shift)


def _round_oracle(nc, shift, mat, nodes, n0, radius):
    """One merge round on numpy state; same contract as `ploc._round`."""
    cols = mat[:6].view(np.float32)
    codes = mat[6].view(np.uint32)
    cnode = mat[7]
    merge, dropped, best = _nn_oracle(cols, _seg(codes, shift), nc, radius)
    base = n0 - nc
    nodes = nodes.copy()
    new_cols = cols.copy()
    new_node = cnode.copy()
    slot = base
    for i in np.nonzero(merge)[0]:
        j = best[i]
        u = np.minimum(cols[:, i], cols[:, j])
        nodes[:, slot] = np.concatenate(
            [[cnode[i], cnode[j]], u.view(np.int32)]
        )
        new_cols[:, i] = u
        new_node[i] = slot
        slot += 1
    keep = np.nonzero((np.arange(mat.shape[1]) < nc) & ~dropped)[0]
    out = np.concatenate(
        [new_cols.view(np.int32), codes.view(np.int32)[None], new_node[None]]
    )[:, keep]
    return nc - int(merge.sum()), min(shift + 3, 32), out, nodes


def _mk_state(rng, size, n_segs=None):
    mn = rng.random((6, size), dtype=np.float32)
    # packed (min3, -max3): -max <= -(min + 0.1) keeps extents positive
    cols = np.concatenate([mn[:3], -(mn[:3] + 0.1 + mn[3:])], axis=0)
    if n_segs is None:
        codes = np.sort(rng.integers(0, 2**30, size)).astype(np.uint32)
    else:
        codes = np.sort(rng.integers(0, n_segs, size)).astype(np.uint32)
    cnode = (np.arange(size) + size - 1).astype(np.int32)
    return np.concatenate(
        [cols.view(np.int32), codes.view(np.int32)[None], cnode[None]]
    ).astype(np.int32)


def _run_nn(mat, nc, shift, radius):
    size = mat.shape[1]
    as_f = lambda x: lax.bitcast_convert_type(x, jnp.float32)
    m = jnp.asarray(mat)
    cols = [as_f(m[k]) for k in range(6)]
    seg = jnp.asarray(_seg(mat[6].view(np.uint32), shift))
    idx = jnp.arange(size, dtype=I32)
    segmat = jnp.stack(cols + [as_f(seg.astype(I32)), as_f(m[7])], axis=0)
    return ploc._nn_round_xla(
        segmat, cols, seg, idx < nc, idx, jnp.asarray(nc, I32), size, radius
    )


@pytest.mark.parametrize(
    "size,nc,nsegs",
    [(256, 256, 1), (384, 300, 7), (128, 5, 2), (1024, 1024, 1), (1024, 900, 11)],
)
@pytest.mark.parametrize("radius", [8, 4])
def test_nn_stage_matches_oracle(size, nc, nsegs, radius):
    rng = np.random.default_rng(size + radius)
    mat = _mk_state(rng, size, n_segs=nsegs)
    merge, dropped, ucols, rnode = _run_nn(mat, nc, 0, radius)
    cols = mat[:6].view(np.float32)
    w_merge, w_dropped, best = _nn_oracle(cols, mat[6].view(np.uint32), nc, radius)
    np.testing.assert_array_equal(np.asarray(merge), w_merge)
    np.testing.assert_array_equal(np.asarray(dropped), w_dropped)
    for i in np.nonzero(w_merge)[0]:
        j = best[i]
        u = np.minimum(cols[:, i], cols[:, j])
        np.testing.assert_array_equal(
            np.array([np.asarray(ucols[k])[i] for k in range(6)]), u
        )
        assert int(np.asarray(rnode)[i]) == mat[7, j]


def test_nn_stage_no_cross_segment_merges():
    rng = np.random.default_rng(0)
    size = 256
    mat = _mk_state(rng, size, n_segs=13)
    merge, _d, _u, rnode = _run_nn(mat, size, 0, 8)
    seg = mat[6]
    partner = np.asarray(rnode) - (size - 1)  # partner's column (cnode = col + size - 1)
    for i in np.nonzero(np.asarray(merge))[0]:
        assert seg[partner[i]] == seg[i]


def _assert_round(state, want):
    nc1, sb1, mat1, nodes1 = [np.asarray(x) for x in state]
    nc_w, sb_w, mat_w, nodes_w = want
    assert int(nc1) == nc_w
    assert int(sb1) == sb_w
    np.testing.assert_array_equal(mat1[:, :mat_w.shape[1]], mat_w)
    np.testing.assert_array_equal(nodes1, nodes_w)


@pytest.mark.parametrize("size,nc", [(384, 384), (512, 300), (1024, 1000)])
@pytest.mark.parametrize("shift", [32, 18])
def test_round_matches_oracle(size, nc, shift):
    rng = np.random.default_rng(size + shift + 7)
    mat = _mk_state(rng, size)
    nodes = rng.integers(-2**30, 2**30, (8, 2 * size + 512)).astype(np.int32)
    state = ploc._round(
        (jnp.asarray(nc, I32), jnp.asarray(shift, I32), jnp.asarray(mat),
         jnp.asarray(nodes)),
        nc, 8,
    )
    _assert_round(state, _round_oracle(nc, shift, mat, nodes, nc, 8))


def test_round_no_merges():
    """Every cluster alone in its segment (HPLOC stall): the state passes
    through unchanged and the node buffer is untouched."""
    rng = np.random.default_rng(3)
    size, nc = 512, 500
    mat = _mk_state(rng, size)
    mat[6] = np.arange(size, dtype=np.int32)  # distinct segments at shift 0
    nodes = rng.integers(-2**30, 2**30, (8, 2 * size + 512)).astype(np.int32)
    nc1, sb1, mat1, nodes1 = ploc._round(
        (jnp.asarray(nc, I32), jnp.asarray(0, I32), jnp.asarray(mat),
         jnp.asarray(nodes)),
        nc, 8,
    )
    assert int(nc1) == nc
    assert int(sb1) == 3
    np.testing.assert_array_equal(np.asarray(mat1)[:, :nc], mat[:, :nc])
    np.testing.assert_array_equal(np.asarray(nodes1), nodes)


@pytest.mark.parametrize("size,nc,shift", [(512, 500, 32), (512, 512, 12), (300, 300, 32)])
def test_rounds_to_completion_match_oracle(size, nc, shift):
    """Iterating `_round` until one cluster remains writes every merged
    node exactly as the iterated oracle does."""
    rng = np.random.default_rng(size + nc + shift)
    mat = _mk_state(rng, size)
    nodes = rng.integers(-2**30, 2**30, (8, 2 * size + 512)).astype(np.int32)
    state = (jnp.asarray(nc, I32), jnp.asarray(shift, I32), jnp.asarray(mat),
             jnp.asarray(nodes))
    want = (nc, shift, mat, nodes)
    for _ in range(200):
        if want[0] <= 1:
            break
        state = ploc._round(state, nc, 8)
        want = _round_oracle(want[0], want[1], want[2], want[3], nc, 8)
        assert int(state[0]) == want[0]
    assert want[0] == 1
    np.testing.assert_array_equal(np.asarray(state[3]), want[3])
