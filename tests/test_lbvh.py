"""End-to-end LBVH builder tests: the reference's debug oracles
(SURVEY.md §4) as pytest invariants."""
import numpy as np
import pytest

from tests.conftest import random_tris
from jax_bvh.models import lbvh
from jax_bvh.utils import validate
from jax_bvh.utils.cost import sah_cost_bvh2


BUILDERS = {
    "two_pass": lbvh.build_two_pass,
    "single_pass": lbvh.build_single_pass,
}


@pytest.mark.parametrize("name", list(BUILDERS))
@pytest.mark.parametrize("extended", [False, True])
def test_cornellbox_invariants(cornellbox_tris, name, extended):
    bvh = BUILDERS[name](cornellbox_tris, use_extended=extended)
    assert validate.check_root_aabb(bvh)
    assert validate.check_bvh2_correctness(bvh, cornellbox_tris.shape[0])
    assert validate.check_parent_child_consistency(bvh)


@pytest.mark.parametrize("name", list(BUILDERS))
@pytest.mark.parametrize("n", [2, 5, 33, 1000])
def test_random_invariants(rng, name, n):
    tris = random_tris(rng, n)
    bvh = BUILDERS[name](tris)
    assert validate.check_root_aabb(bvh)
    assert validate.check_bvh2_correctness(bvh, n)
    assert validate.check_parent_child_consistency(bvh)


def test_builders_agree_on_sah(cornellbox_tris):
    """Same radix tree => identical SAH cost (the reference's two LBVH
    builders report identical costs, README.md:61 vs :103)."""
    c1 = float(sah_cost_bvh2(lbvh.build_two_pass(cornellbox_tris)))
    c2 = float(sah_cost_bvh2(lbvh.build_single_pass(cornellbox_tris)))
    assert c1 == pytest.approx(c2, rel=1e-6)


def test_builders_agree_on_sah_random(rng):
    tris = random_tris(rng, 4096)
    c1 = float(sah_cost_bvh2(lbvh.build_two_pass(tris)))
    c2 = float(sah_cost_bvh2(lbvh.build_single_pass(tris)))
    assert c1 == pytest.approx(c2, rel=1e-5)


def test_duplicate_positions(rng):
    """All-identical triangles: every Morton code collides; the index
    tie-break must still produce a valid tree."""
    tri = random_tris(rng, 1)
    tris = np.repeat(tri, 64, axis=0)
    for name, build in BUILDERS.items():
        bvh = build(tris)
        assert validate.check_bvh2_correctness(bvh, 64), name


def test_determinism(cornellbox_tris):
    """Unlike the reference's float-atomic reductions, builds are
    bit-deterministic."""
    a = lbvh.build_two_pass(cornellbox_tris)
    b = lbvh.build_two_pass(cornellbox_tris)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
