"""Triton raster kernel (interpret mode) vs XLA raster and wavefront oracle."""
import jax
import jax.numpy as jnp
import numpy as np

from jax_bvh.models import lbvh
from jax_bvh.ops import raster, raster_triton, traverse
from jax_bvh.utils import camera, scenes


def _run(tris_np, scene_name, w=128, h=128, leaf=16):
    tris = jnp.asarray(tris_np)
    tr, cam = scenes.preset(scene_name)
    rays = camera.generate_rays(cam, w, h)
    bvh = lbvh.build_two_pass(tris)
    packed = raster.pack_raster(bvh, tris, leaf_size=leaf)

    hit_k, counts, overflow = raster_triton.render_raster_triton(
        packed, rays, tr, w, h, cand_cap=64, interpret=True,
    )
    assert not bool(overflow)
    # heat-map signal: hitting rays must have swept at least one treelet
    ck = np.asarray(counts)
    assert (ck[np.asarray(hit_k.prim_idx) >= 0] > 0).all()
    hit_o, _ = traverse.traverse_bvh2(bvh, tris, rays, tr, variant="speculative")

    pk = np.asarray(hit_k.prim_idx)
    po = np.asarray(hit_o.prim_idx)
    tk = np.asarray(hit_k.t)
    to = np.asarray(hit_o.t)
    np.testing.assert_array_equal(pk >= 0, po >= 0)
    both = pk >= 0
    # fixed-eye coefficients reassociate the oracle's arithmetic, and
    # coefficient cancellation on random soups amplifies the rounding
    # (worst observed: 6e-4 absolute on t~0.03 hits); prim identity above
    # is the strong equality check
    np.testing.assert_allclose(tk[both], to[both], rtol=1e-3, atol=1e-3)
    diff = both & (pk != po)
    if diff.any():
        assert np.allclose(tk[diff], to[diff], rtol=1e-3)
    same = both & (pk == po)
    np.testing.assert_allclose(
        np.asarray(hit_k.u)[same], np.asarray(hit_o.u)[same],
        rtol=1e-3, atol=1e-3,
    )


def test_kernel_cornellbox():
    _run(scenes.cornellbox(), "cornellbox")


def test_kernel_random_soup():
    rng = np.random.default_rng(5)
    base = rng.uniform(-1.5, 1.5, (200, 1, 3)).astype(np.float32)
    tri = base + rng.uniform(-0.3, 0.3, (200, 3, 3)).astype(np.float32)
    _run(tri, "cornellbox", leaf=16)


def test_kernel_matches_xla_raster():
    tris = jnp.asarray(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    w = h = 64
    rays = camera.generate_rays(cam, w, h)
    bvh = lbvh.build_two_pass(tris)
    packed = raster.pack_raster(bvh, tris, leaf_size=8)

    hit_k, _ck, ovf_k = raster_triton.render_raster_triton(
        packed, rays, tr, w, h, cand_cap=32, interpret=True,
    )
    hit_x, _, ovf_x = raster.render_raster_xla(
        packed, rays, tr, w, h, tile=16, cap_a=8, cap_b=32, tiles_b=16
    )
    assert not bool(ovf_k) and not bool(ovf_x)
    np.testing.assert_array_equal(
        np.asarray(hit_k.prim_idx), np.asarray(hit_x.prim_idx)
    )
    both = np.asarray(hit_k.prim_idx) >= 0
    np.testing.assert_allclose(
        np.asarray(hit_k.t)[both], np.asarray(hit_x.t)[both], rtol=1e-5
    )


def test_coarse_layout_roundtrip():
    w, h = 128, 64
    x = jnp.arange(w * h * 3, dtype=jnp.float32).reshape(w * h, 3)
    ct = raster_triton._to_coarse_layout(x.reshape(w, h, 3), w, h)
    back = raster_triton._from_coarse_layout(ct, w, h)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))


def test_kernel_unaligned_dims_pad_crop():
    """Non-64-multiple render dims (e.g. 1080p's height) pad internally
    with edge-replicated rays and crop back — same hits as the XLA oracle."""
    tris = jnp.asarray(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    w, h = 96, 80  # neither is a multiple of the 64-px coarse tile
    rays = camera.generate_rays(cam, w, h)
    bvh = lbvh.build_two_pass(tris)
    packed = raster.pack_raster(bvh, tris, leaf_size=8)

    hit_k, counts, ovf_k = raster_triton.render_raster_triton(
        packed, rays, tr, w, h, cand_cap=32, interpret=True,
    )
    assert hit_k.prim_idx.shape == (w * h,)
    assert counts.shape == (w * h,)
    hit_x, _, _ = raster.render_raster_xla(packed, rays, tr, w, h)
    assert not bool(ovf_k)
    np.testing.assert_array_equal(
        np.asarray(hit_k.prim_idx), np.asarray(hit_x.prim_idx)
    )
    both = np.asarray(hit_k.prim_idx) >= 0
    np.testing.assert_allclose(
        np.asarray(hit_k.t)[both], np.asarray(hit_x.t)[both], rtol=1e-5
    )
