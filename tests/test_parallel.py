"""Sharded paths on the 8-device virtual CPU mesh."""
import numpy as np
import pytest

from tests.conftest import random_tris
from jax_bvh.models import batched
from jax_bvh.utils import validate


def test_batched_build(rng):
    meshes = [random_tris(rng, int(n)) for n in rng.integers(2, 33, size=16)]
    tris_b, counts = batched.pad_meshes(meshes)
    bvhs = batched.build_batched(tris_b)
    for i in range(len(meshes)):
        one = type(bvhs)(*[np.asarray(f)[i] for f in bvhs])
        assert validate.check_bvh2_correctness(one, tris_b.shape[1])
        assert validate.check_root_aabb(one)


def test_batched_sharded(rng):
    import jax
    from jax_bvh.parallel import sharded

    mesh = sharded.default_mesh()
    b = mesh.devices.size * 4
    meshes = [random_tris(rng, 32) for _ in range(b)]
    tris_b, _ = batched.pad_meshes(meshes)
    bvhs = sharded.build_batched_sharded(mesh, tris_b)
    ref = batched.build_batched(tris_b)
    for got, want in zip(bvhs, ref):
        assert np.allclose(np.asarray(got), np.asarray(want))


def test_sharded_extents(rng):
    from jax_bvh.parallel import sharded

    mesh = sharded.default_mesh()
    tris = random_tris(rng, 8 * 100)
    lo, hi = sharded.sharded_scene_extents(mesh, tris)
    assert np.allclose(np.asarray(lo), tris.reshape(-1, 3).min(axis=0))
    assert np.allclose(np.asarray(hi), tris.reshape(-1, 3).max(axis=0))


@pytest.mark.slow
def test_sharded_traversal(rng):
    import jax.numpy as jnp
    from jax_bvh.models import lbvh
    from jax_bvh.ops import traverse
    from jax_bvh.parallel import sharded
    from jax_bvh.utils import scenes, camera

    tris = jnp.asarray(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    rays = camera.generate_rays(cam, 32, 32)
    bvh = lbvh.build_two_pass(tris)

    mesh = sharded.default_mesh()
    hit_s, counts_s = sharded.traverse_sharded(mesh, bvh, tris, rays, tr)
    hit, counts = traverse.traverse_bvh2(bvh, tris, rays, tr)
    assert np.array_equal(np.asarray(hit_s.prim_idx), np.asarray(hit.prim_idx))
    assert np.allclose(np.asarray(hit_s.t), np.asarray(hit.t))


@pytest.mark.slow
def test_sharded_raster_render():
    import jax.numpy as jnp
    from jax_bvh.models import lbvh
    from jax_bvh.ops import raster, traverse
    from jax_bvh.parallel import sharded
    from jax_bvh.utils import scenes, camera

    tris = jnp.asarray(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    W = H = 128
    rays = camera.generate_rays(cam, W, H)
    bvh = lbvh.build_two_pass(tris)
    packed = raster.pack_raster(bvh, tris, leaf_size=8)

    mesh = sharded.default_mesh(2)
    hit = sharded.render_raster_sharded(mesh, packed, rays, tr, W, H)
    hit_o, _ = traverse.traverse_bvh2(bvh, tris, rays, tr)
    pk = np.asarray(hit.prim_idx)
    po = np.asarray(hit_o.prim_idx)
    assert np.array_equal(pk >= 0, po >= 0)
    mask = pk >= 0
    assert np.allclose(np.asarray(hit.t)[mask], np.asarray(hit_o.t)[mask], rtol=1e-4)


def test_sharded_raster_leaves_no_tracer(monkeypatch):
    """The sharded render runs its shard_map under jit. Run eagerly, a
    shard_map that reaches the Triton kernel leaves a shard_map tracer
    behind, and the next one-device render fails on it instead of lowering.
    The compiled kernel cannot lower on the CPU, so both calls must raise
    that error and no other."""
    import jax.numpy as jnp
    from jax_bvh.models import lbvh
    from jax_bvh.ops import raster
    from jax_bvh.parallel import sharded
    from jax_bvh.utils import scenes, camera

    monkeypatch.setattr(raster, "raster_engine", lambda: "triton")
    tris = jnp.asarray(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    W, H = 256, 64
    rays = camera.generate_rays(cam, W, H)
    packed = raster.pack_raster(lbvh.build_two_pass(tris), tris, leaf_size=8)
    with pytest.raises(ValueError, match="interpret"):
        sharded.render_raster_sharded(sharded.default_mesh(4), packed, rays, tr, W, H)
    with pytest.raises(ValueError, match="interpret"):
        raster.render_raster(packed, rays, tr, W, H)


@pytest.mark.slow
def test_batched_small_matches_vmapped_single_pass(rng):
    """The dense all-pairs small-capacity path must produce bit-identical
    trees to the vmapped generic single-pass builder."""
    import jax
    import numpy as np
    from jax_bvh.models import batched, lbvh

    meshes = [random_tris(rng, int(n)) for n in rng.integers(2, 33, size=24)]
    tris_b, _ = batched.pad_meshes(meshes)
    got = batched._build_batched_small(jax.numpy.asarray(tris_b))
    want = jax.vmap(
        lambda t: lbvh.build_single_pass(t, use_extended=False)
    )(jax.numpy.asarray(tris_b))
    for g, w, name in zip(got, want, got._fields):
        assert np.array_equal(np.asarray(g), np.asarray(w)), name
