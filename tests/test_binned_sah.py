"""Binned SAH CPU builder: correctness + quality + interop with the shared
traversal path."""
import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import random_tris
from jax_bvh.models import binned_sah, lbvh
from jax_bvh.ops import traverse
from jax_bvh.utils import scenes, camera, validate
from jax_bvh.utils.cost import sah_cost_bvh2


@pytest.mark.parametrize("n", [1, 2, 3, 17, 500])
def test_correctness(rng, n):
    tris = random_tris(rng, n)
    bvh = binned_sah.build_binned_sah(tris)
    assert binned_sah.check_correctness(bvh, n)


@pytest.mark.slow
def test_quality_beats_lbvh(rng):
    """SAH builds should be at least as good as Morton LBVH on clumpy
    scenes."""
    tris = random_tris(rng, 2000, spread=20.0, size=0.2)
    sah = binned_sah.build_binned_sah(tris)
    sah_as_bvh2 = binned_sah.to_bvh2(sah)
    lb = lbvh.build_two_pass(jnp.asarray(tris))
    c_sah = float(sah_cost_bvh2(sah_as_bvh2))
    c_lbvh = float(sah_cost_bvh2(lb))
    assert c_sah < c_lbvh * 1.1


def test_to_bvh2_roundtrip_and_traversal(cornellbox_tris):
    sah = binned_sah.build_binned_sah(cornellbox_tris)
    bvh = binned_sah.to_bvh2(sah)
    assert validate.check_bvh2_correctness(bvh, cornellbox_tris.shape[0])
    assert validate.check_parent_child_consistency(bvh)

    tris = jnp.asarray(cornellbox_tris)
    tr, cam = scenes.preset("cornellbox")
    rays = camera.generate_rays(cam, 16, 16)
    hit_sah, _ = traverse.traverse_bvh2(bvh, tris, rays, tr)
    hit_lbvh, _ = traverse.traverse_bvh2(lbvh.build_two_pass(tris), tris, rays, tr)
    assert np.array_equal(np.asarray(hit_sah.prim_idx), np.asarray(hit_lbvh.prim_idx))
