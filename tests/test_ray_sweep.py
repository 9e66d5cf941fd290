"""General-ray Plücker sweep engine vs wavefront oracle.

Covers the reference's arbitrary-ray traversal capability
(`src/TraversalKernel.h:337-451`): primary rays, shadow
rays with surface origins + finite tmax, and fully random ray sets.
"""
import jax.numpy as jnp
import numpy as np

from jax_bvh.models import lbvh
from jax_bvh.ops import raster, ray_sweep, traverse
from jax_bvh.types import Rays
from jax_bvh.utils import camera, scenes


def _compare(hit_k, hit_o, counts=None):
    pk = np.asarray(hit_k.prim_idx)
    po = np.asarray(hit_o.prim_idx)
    tk = np.asarray(hit_k.t)
    to = np.asarray(hit_o.t)
    np.testing.assert_array_equal(pk >= 0, po >= 0)
    both = pk >= 0
    if counts is not None:
        assert (np.asarray(counts)[both] > 0).all()
    np.testing.assert_allclose(tk[both], to[both], rtol=1e-3, atol=1e-3)
    diff = both & (pk != po)
    if diff.any():  # t-ties may pick a different but equally close prim
        assert np.allclose(tk[diff], to[diff], rtol=1e-3)
    same = both & (pk == po)
    np.testing.assert_allclose(
        np.asarray(hit_k.u)[same], np.asarray(hit_o.u)[same],
        rtol=1e-3, atol=1e-3,
    )
    return both


def _pack(tris_np, leaf=16):
    tris = jnp.asarray(tris_np)
    bvh = lbvh.build_two_pass(tris)
    return bvh, tris, raster.pack_raster(bvh, tris, leaf_size=leaf)


def test_primary_rays_cornellbox():
    bvh, tris, packed = _pack(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    w = h = 64
    rays = camera.generate_rays(cam, w, h)
    hit_k, counts, ovf = ray_sweep.trace_rays(
        packed, rays, tr, cand_cap=64
    )
    assert not bool(ovf)
    hit_o, _ = traverse.traverse_bvh2(
        bvh, tris, rays, tr, variant="speculative"
    )
    both = _compare(hit_k, hit_o, counts)
    assert both.any()  # the view actually hits geometry


def test_shadow_rays_surface_origins():
    """Shadow rays: origins on hit surfaces, direction to a point light,
    tmax = light distance (the capability the fixed-eye raster lacks)."""
    bvh, tris, packed = _pack(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    w = h = 48
    prim_rays = camera.generate_rays(cam, w, h)
    hit_p, _ = traverse.traverse_bvh2(
        bvh, tris, prim_rays, tr, variant="speculative"
    )
    hitm = np.asarray(hit_p.prim_idx) >= 0
    t = np.where(hitm, np.asarray(hit_p.t), 0.0)  # park missed rays at eye
    o = np.asarray(prim_rays.origin) + np.asarray(prim_rays.direction) * t[:, None]
    light = np.array([0.0, 0.9, 0.2], np.float32)
    dvec = light[None, :] - o
    dist = np.linalg.norm(dvec, axis=1)
    dirs = dvec / np.maximum(dist, 1e-9)[:, None]
    # offset along the shadow direction; dead rays (miss) get tmax -1
    eps = 1e-3
    rays = Rays(
        origin=jnp.asarray(o + dirs * eps),
        direction=jnp.asarray(dirs),
        tmin=jnp.zeros((w * h,), jnp.float32),
        tmax=jnp.asarray(np.where(hitm, dist - 2 * eps, -1.0).astype(np.float32)),
    )
    hit_k, _, ovf = ray_sweep.trace_rays(
        packed, rays, tr, cand_cap=64
    )
    assert not bool(ovf)
    hit_o, _ = traverse.traverse_bvh2(
        bvh, tris, rays, tr, variant="speculative"
    )
    # the oracle ignores tmax; rebuild its answer with the cap applied
    to = np.asarray(hit_o.t)
    po = np.asarray(hit_o.prim_idx)
    tmax = np.asarray(rays.tmax)
    capped = (po >= 0) & (to < tmax)
    hit_o_capped = hit_o._replace(
        prim_idx=jnp.where(jnp.asarray(capped), hit_o.prim_idx, -1),
        t=jnp.where(jnp.asarray(capped), hit_o.t, jnp.float32(3.4e38)),
        u=jnp.where(jnp.asarray(capped), hit_o.u, 0.0),
        v=jnp.where(jnp.asarray(capped), hit_o.v, 0.0),
    )
    both = _compare(hit_k, hit_o_capped)
    # a cornell box interior has both lit and occluded points
    assert both.any() and (~both & hitm).any()


def test_random_ray_set():
    rng = np.random.default_rng(11)
    base = rng.uniform(-1.5, 1.5, (150, 1, 3)).astype(np.float32)
    tris_np = base + rng.uniform(-0.4, 0.4, (150, 3, 3)).astype(np.float32)
    bvh, tris, packed = _pack(tris_np, leaf=16)
    tr, _ = scenes.preset("cornellbox")
    n = 500
    o = rng.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(
        origin=jnp.asarray(o),
        direction=jnp.asarray(d),
        tmin=jnp.zeros((n,), jnp.float32),
        tmax=jnp.full((n,), 3.4e38, jnp.float32),
    )
    hit_k, _, ovf = ray_sweep.trace_rays(
        packed, rays, tr, cand_cap=32
    )
    assert not bool(ovf)
    hit_o, _ = traverse.traverse_bvh2(
        bvh, tris, rays, tr, variant="speculative"
    )
    _compare(hit_k, hit_o)


def test_overflow_flag_fires():
    """Undersized candidate cap must raise the overflow flag, not silently
    drop hits."""
    bvh, tris, packed = _pack(scenes.cornellbox(), leaf=8)
    tr, cam = scenes.preset("cornellbox")
    rays = camera.generate_rays(cam, 16, 16)
    _, _, ovf = ray_sweep.trace_rays(
        packed, rays, tr, cand_cap=1
    )
    assert bool(ovf)


def test_shadow_occlusion_reversed():
    """Reversed point-light occlusion equals the forward capped answer
    (direction symmetry of segment occlusion)."""
    bvh, tris, packed = _pack(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    w = h = 48
    prim_rays = camera.generate_rays(cam, w, h)
    hit_p, _ = traverse.traverse_bvh2(
        bvh, tris, prim_rays, tr, variant="speculative"
    )
    hitm = np.asarray(hit_p.prim_idx) >= 0
    t = np.where(hitm, np.asarray(hit_p.t), 0.0)
    o = np.asarray(prim_rays.origin) + np.asarray(prim_rays.direction) * t[:, None]
    light = np.array([0.0, 0.9, 0.2], np.float32)
    eps = 1e-3
    occ, counts, ovf = ray_sweep.shadow_occlusion(
        packed, jnp.asarray(o), jnp.asarray(hitm), jnp.asarray(light), tr,
        eps, cand_cap=64
    )
    assert not bool(ovf)
    # forward oracle with the same segment cap
    dvec = light[None, :] - o
    dist = np.linalg.norm(dvec, axis=1)
    dirs = dvec / np.maximum(dist, 1e-9)[:, None]
    frays = Rays(
        origin=jnp.asarray(o + dirs * eps),
        direction=jnp.asarray(dirs),
        tmin=jnp.zeros((w * h,), jnp.float32),
        tmax=jnp.asarray(np.where(hitm, dist - 2 * eps, -1.0).astype(np.float32)),
    )
    hit_o, _ = traverse.traverse_bvh2(
        bvh, tris, frays, tr, variant="speculative"
    )
    to = np.asarray(hit_o.t)
    po = np.asarray(hit_o.prim_idx)
    tmax = np.asarray(frays.tmax)
    occ_fwd = (po >= 0) & (to < tmax)
    occ_np = np.asarray(occ)
    # boundary strips (grazing either endpoint) may flip either way
    to_safe = np.where(po >= 0, to, np.inf)
    boundary = (np.abs(to_safe - tmax) < 10 * eps) | (to_safe < 10 * eps)
    np.testing.assert_array_equal(occ_np[~boundary], occ_fwd[~boundary])
    assert occ_np.any() and (~occ_np & hitm).any()  # both classes present
    assert not occ_np[~hitm].any()  # dead rays never occluded
