"""PLOC++ / HPLOC builder invariants + quality vs LBVH."""
import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import random_tris
from jax_bvh.models import lbvh, ploc
from jax_bvh.ops import collapse, traverse
from jax_bvh.utils import validate, scenes, camera
from jax_bvh.utils.cost import sah_cost_bvh2

BUILDERS = {"ploc": ploc.build_ploc, "hploc": ploc.build_hploc}


@pytest.mark.parametrize("name", list(BUILDERS))
@pytest.mark.parametrize("n", [2, 3, 9, 64, 700])
@pytest.mark.slow
def test_invariants(rng, name, n):
    tris = random_tris(rng, n)
    bvh = BUILDERS[name](tris)
    assert validate.check_bvh2_correctness(bvh, n), name
    assert validate.check_root_aabb(bvh), name
    assert validate.check_parent_child_consistency(bvh), name


@pytest.mark.parametrize("name", list(BUILDERS))
def test_cornellbox(cornellbox_tris, name):
    bvh = BUILDERS[name](cornellbox_tris)
    assert validate.check_bvh2_correctness(bvh, cornellbox_tris.shape[0])
    assert validate.check_root_aabb(bvh)


@pytest.mark.slow
def test_quality_at_least_lbvh(rng):
    """PLOC's agglomerative clustering should beat plain LBVH on SAH
    (the reference's tables: PLOC 21.9 vs LBVH 22.6 on bunny,
    README.md:187 vs :61)."""
    tris = random_tris(rng, 3000, spread=15.0, size=0.4)
    c_ploc = float(sah_cost_bvh2(ploc.build_ploc(tris)))
    c_lbvh = float(sah_cost_bvh2(lbvh.build_two_pass(tris)))
    assert c_ploc <= c_lbvh * 1.05
    c_hploc = float(sah_cost_bvh2(ploc.build_hploc(tris)))
    assert c_hploc <= c_lbvh * 1.1


@pytest.mark.slow
def test_duplicate_codes(rng):
    tris = np.repeat(random_tris(rng, 1), 33, axis=0)
    for name, build in BUILDERS.items():
        bvh = build(tris)
        assert validate.check_bvh2_correctness(bvh, 33), name


def test_collapse_and_traverse_ploc_tree(cornellbox_tris):
    """PLOC trees plug into the shared collapse + traversal paths (the
    reference reuses its collapse kernel across builders,
    `Hploc.cpp:144-156`)."""
    tris = jnp.asarray(cornellbox_tris)
    bvh = ploc.build_ploc(tris)
    wide = collapse.collapse_bvh2_to_bvh4(bvh)
    assert validate.check_bvh4_correctness(wide, tris.shape[0])

    tr, cam = scenes.preset("cornellbox")
    rays = camera.generate_rays(cam, 16, 16)
    hit_p, _ = traverse.traverse_bvh2(bvh, tris, rays, tr)
    hit_l, _ = traverse.traverse_bvh2(lbvh.build_two_pass(tris), tris, rays, tr)
    assert np.array_equal(np.asarray(hit_p.prim_idx), np.asarray(hit_l.prim_idx))
