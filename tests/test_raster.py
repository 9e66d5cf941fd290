"""Raster traversal vs wavefront oracle.

The raster engine must produce the same closest hits as `traverse_bvh2`
(same triangle formula); prim ids may differ only where two primitives are
hit at (near-)identical t.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax_bvh.models import lbvh
from jax_bvh.ops import raster, traverse
from jax_bvh.utils import camera, scenes


def _check_match(hit_r, hit_o, rays, tris, tr, rtol=1e-4):
    pr = np.asarray(hit_r.prim_idx)
    po = np.asarray(hit_o.prim_idx)
    tr_ = np.asarray(hit_r.t)
    to = np.asarray(hit_o.t)

    hit_mask_r = pr >= 0
    hit_mask_o = po >= 0
    # same pixels hit
    np.testing.assert_array_equal(hit_mask_r, hit_mask_o)
    both = hit_mask_r
    if both.sum() == 0:
        return
    # same distances
    np.testing.assert_allclose(tr_[both], to[both], rtol=rtol)
    # same prims except genuine t-ties
    diff = both & (pr != po)
    if diff.any():
        # any disagreement must be a near-tie in t
        assert np.allclose(tr_[diff], to[diff], rtol=1e-3), (
            f"{diff.sum()} prim mismatches with non-tied t"
        )
    # barycentrics agree where prims agree
    same = both & (pr == po)
    np.testing.assert_allclose(
        np.asarray(hit_r.u)[same], np.asarray(hit_o.u)[same], rtol=1e-3, atol=1e-4
    )


def _run_case(tris_np, scene_name, w=64, h=64, tile=16, leaf=16, cap=64):
    tris = jnp.asarray(tris_np)
    tr, cam = scenes.preset(scene_name)
    rays = camera.generate_rays(cam, w, h)
    bvh = lbvh.build_two_pass(tris)

    packed = raster.pack_raster(bvh, tris, leaf_size=leaf)
    hit_r, counts, overflow = raster.render_raster_xla(
        packed, rays, tr, w, h, tile=tile, cap_a=8, cap_b=cap, tiles_b=16
    )
    assert not bool(overflow), "treelet candidate cap overflowed"

    hit_o, _ = traverse.traverse_bvh2(bvh, tris, rays, tr, variant="speculative")
    _check_match(hit_r, hit_o, rays, tris, tr)
    assert int(jnp.sum(counts)) > 0


def test_raster_cornellbox():
    _run_case(scenes.cornellbox(), "cornellbox")


@pytest.mark.slow
def test_raster_random_soup():
    rng = np.random.default_rng(7)
    base = rng.uniform(-1.5, 1.5, (300, 1, 3)).astype(np.float32)
    tri = base + rng.uniform(-0.25, 0.25, (300, 3, 3)).astype(np.float32)
    # camera preset expects a cornellbox-ish scene volume
    _run_case(tri, "cornellbox", leaf=32, cap=128)


def test_raster_counts_are_conservative_superset():
    """Every ray's swept-prim count is at least 1 treelet's worth when it
    hits something."""
    tris = jnp.asarray(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    rays = camera.generate_rays(cam, 32, 32)
    bvh = lbvh.build_two_pass(tris)
    packed = raster.pack_raster(bvh, tris, leaf_size=16)
    hit, counts, overflow = raster.render_raster_xla(
        packed, rays, tr, 32, 32, tile=16, cap_a=4, cap_b=32, tiles_b=8
    )
    assert not bool(overflow)
    hits = np.asarray(hit.prim_idx) >= 0
    assert (np.asarray(counts)[hits] > 0).all()


def test_cone_vs_aabb_oracle():
    """Conservativeness of the direction-interval cone test: sampled rays
    inside the cone that hit the AABB must imply possible=True."""
    rng = np.random.default_rng(3)
    eye = jnp.asarray(rng.normal(0, 1, 3).astype(np.float32))
    for _ in range(50):
        d0 = rng.normal(0, 1, 3).astype(np.float32)
        d0 /= np.linalg.norm(d0)
        spread = rng.uniform(0.01, 0.3)
        ds = d0 + rng.uniform(-spread, spread, (64, 3)).astype(np.float32)
        dmin = jnp.asarray(ds.min(0))
        dmax = jnp.asarray(ds.max(0))
        c = rng.normal(0, 3, 3).astype(np.float32)
        half = rng.uniform(0.1, 1.0, 3).astype(np.float32)
        bmin = jnp.asarray(c - half)
        bmax = jnp.asarray(c + half)
        possible, t_lb = raster._cone_vs_aabb(eye, dmin, dmax, bmin, bmax)
        # brute force: does any sampled ray hit?
        from jax_bvh.ops import aabb as A

        inv = 1.0 / jnp.asarray(ds)
        tn, tf = A.slab_intersect(
            bmin, bmax, eye[None], inv, jnp.full((64,), 1e30)
        )
        any_hit = bool(jnp.any(tn <= tf))
        if any_hit:
            assert bool(possible), "cone test missed a real hit"
            # and the lower bound must actually lower-bound entry t
            assert float(t_lb) <= float(jnp.min(jnp.where(tn <= tf, tn, 1e30))) + 1e-3


def test_moller_coefs_match_intersect_triangle():
    rng = np.random.default_rng(11)
    tris = jnp.asarray(rng.normal(0, 1, (40, 3, 3)).astype(np.float32))
    eye = jnp.asarray(rng.normal(0, 2, 3).astype(np.float32))
    d = rng.normal(0, 1, (16, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = jnp.asarray(d)

    coefs, t0 = raster._moller_coefs(tris, eye)
    p = tris.shape[0]
    planes = (d @ coefs.reshape(p * 4, 3).T).reshape(16, p, 4)
    den = planes[..., 3]
    safe = jnp.where(den != 0, den, 1.0)

    from jax_bvh.ops import aabb as A

    u_o, v_o, w_o, t_o = A.intersect_triangle(
        tris[None, :, 0],
        tris[None, :, 1],
        tris[None, :, 2],
        eye[None, None],
        d[:, None],
    )
    np.testing.assert_allclose(
        np.asarray(planes[..., 0] / safe), np.asarray(u_o), rtol=2e-3, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(t0[None, :] / safe), np.asarray(t_o), rtol=2e-3, atol=2e-4
    )
