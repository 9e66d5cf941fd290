"""BVH2->BVH4 collapse: device frontier-BFS vs the sequential CPU oracle
(`Utility.cpp:540-611` semantics), plus structural checks and SAH costs."""
import numpy as np
import pytest

from tests.conftest import random_tris
from jax_bvh.models import lbvh
from jax_bvh.ops import collapse
from jax_bvh.ops.aabb import triangle_aabbs
from jax_bvh.utils import cpu_reference, validate
from jax_bvh.utils.cost import sah_cost_bvh2, sah_cost_bvh4


@pytest.mark.parametrize("n", [2, 3, 4, 9, 33, 500])
def test_collapse_matches_cpu_oracle(rng, n):
    tris = random_tris(rng, n)
    bvh = lbvh.build_two_pass(tris)
    got = collapse.collapse_bvh2_to_bvh4(bvh)
    want = cpu_reference.collapse_cpu(bvh)
    assert int(got.n_nodes) == want["n_nodes"]
    k = want["n_nodes"]
    assert np.array_equal(np.asarray(got.child)[:k], want["child"][:k])
    assert np.array_equal(np.asarray(got.parent)[:k], want["parent"][:k])
    assert np.array_equal(np.asarray(got.child_count)[:k], want["child_count"][:k])
    assert np.array_equal(np.asarray(got.leaf_prim), want["leaf_prim"])
    assert np.array_equal(np.asarray(got.leaf_parent), want["leaf_parent"])
    # AABBs of used slots
    slots = want["child"][:k] >= 0
    assert np.allclose(np.asarray(got.child_min)[:k][slots], want["child_min"][:k][slots])
    assert np.allclose(np.asarray(got.child_max)[:k][slots], want["child_max"][:k][slots])


@pytest.mark.parametrize("n", [2, 64, 1000])
def test_collapse_visits_all_prims(rng, n):
    tris = random_tris(rng, n)
    bvh = lbvh.build_two_pass(tris)
    wide = collapse.collapse_bvh2_to_bvh4(bvh)
    assert validate.check_bvh4_correctness(wide, n)


def test_collapse_reduces_cost(cornellbox_tris):
    """Collapsing roughly halves SAH cost (`README.md:19`: bunny ~46->~22)."""
    bvh = lbvh.build_two_pass(cornellbox_tris)
    wide = collapse.collapse_bvh2_to_bvh4(bvh)
    mn, mx = triangle_aabbs(cornellbox_tris)
    c2 = float(sah_cost_bvh2(bvh))
    c4 = float(sah_cost_bvh4(wide, mn, mx))
    assert c4 < 0.7 * c2


@pytest.mark.parametrize("n", [3, 33, 500])
@pytest.mark.slow
def test_analytic_collapse_matches_oracle(rng, n):
    """The closed-form (queue-free) derivation reproduces the oracle
    byte-for-byte — it is the executable spec the blocked kernel targets."""
    from jax_bvh.ops.collapse_analytic import collapse_bvh2_to_bvh4_analytic

    tris = random_tris(rng, n)
    for bvh in (lbvh.build_two_pass(tris), lbvh.build_single_pass(tris)):
        got = collapse_bvh2_to_bvh4_analytic(bvh)
        want = cpu_reference.collapse_cpu(bvh)
        k = want["n_nodes"]
        assert int(got.n_nodes) == k
        assert np.array_equal(np.asarray(got.child)[:k], want["child"][:k])
        assert np.array_equal(np.asarray(got.parent)[:k], want["parent"][:k])
        assert np.array_equal(np.asarray(got.leaf_prim), want["leaf_prim"])
        assert np.array_equal(
            np.asarray(got.leaf_parent), want["leaf_parent"]
        )


def test_collapse_single_pass_builder(rng):
    """Collapse works off the Apetrei layout too (root != 0), like the
    reference reuses one collapse kernel across builders
    (`SinglePassLbvh.cpp:158-170`)."""
    tris = random_tris(rng, 200)
    bvh = lbvh.build_single_pass(tris)
    wide = collapse.collapse_bvh2_to_bvh4(bvh)
    assert validate.check_bvh4_correctness(wide, 200)
    want = cpu_reference.collapse_cpu(bvh)
    assert int(wide.n_nodes) == want["n_nodes"]
    assert np.array_equal(np.asarray(wide.leaf_prim), want["leaf_prim"])


def _assert_matches_oracle(bvh, n_prims):
    got = collapse.collapse_bvh2_to_bvh4(bvh)
    want = cpu_reference.collapse_cpu(bvh)
    k = want["n_nodes"]
    assert int(got.n_nodes) == k
    for f in ("child", "parent", "child_count"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f))[:k], want[f][:k])
    for f in ("leaf_prim", "leaf_parent"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), want[f])
    # slot AABBs byte-for-byte on used slots
    used = np.arange(4)[None, :] < want["child_count"][:k][:, None]
    for f in ("child_min", "child_max"):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f))[:k][used], want[f][:k][used]
        )
    assert validate.check_bvh4_correctness(got, n_prims)


def _caterpillar_tris(n_cluster=330, n_chain=26):
    """Chain-shaped crown: a tight cluster (balanced subtree, short ranges)
    plus geometrically-spaced outliers along x — every chain ancestor's
    range contains the whole cluster, so the crown is one long chain."""
    tris = []
    for i in range(n_cluster):
        x = 1e-4 * (i / n_cluster)
        tris.append([[x, 0, 0], [x + 1e-6, 1e-6, 0], [x, 0, 1e-6]])
    for i in range(n_chain):
        x = 2.0 ** (i - n_chain)  # 2^-26 ... 0.5: one new top bit each
        tris.append([[x, 0, 0], [x + 1e-6, 1e-6, 0], [x, 0, 1e-6]])
    return np.asarray(tris, np.float32)


def _scene(name):
    rng = np.random.default_rng(1234)
    if name == "cornellbox":
        from jax_bvh.utils import scenes

        return np.asarray(scenes.cornellbox(), np.float32)
    if name == "random_small":
        return random_tris(rng, 513)
    if name == "random_multislab":
        return random_tris(rng, 3000, spread=30.0)
    if name == "duplicate_codes":
        # coplanar stacks of identical triangles -> massive Morton-code ties
        return np.repeat(random_tris(rng, 64), 16, axis=0)
    if name == "chain_crown":
        return _caterpillar_tris()
    raise ValueError(name)


@pytest.mark.parametrize(
    "scene",
    ["cornellbox", "random_small", "random_multislab", "duplicate_codes",
     "chain_crown"],
)
def test_single_pass_scenes_match_oracle(scene):
    """The boundary-layout (single-pass) trees the timed path collapses,
    byte-exact against the sequential oracle."""
    tris = _scene(scene)
    _assert_matches_oracle(lbvh.build_single_pass(tris), tris.shape[0])


def test_multi_slab_queue_matches_oracle(monkeypatch):
    """A slab far smaller than the task queue, so the BFS cursor crosses
    many slab boundaries."""
    monkeypatch.setattr(collapse, "SLAB", 64)
    collapse.collapse_bvh2_to_bvh4.clear_cache()  # SLAB is read at trace time
    try:
        tris = _scene("random_multislab")
        _assert_matches_oracle(lbvh.build_single_pass(tris), tris.shape[0])
    finally:
        collapse.collapse_bvh2_to_bvh4.clear_cache()
