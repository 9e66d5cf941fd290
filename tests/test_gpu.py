"""Checks that need a GPU: the compiled Triton raster kernel and the sweep
engine on the card, at small sizes. They skip elsewhere; `chip_smoke.py`
runs them in its "gpu tests" phase."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax_bvh.models import lbvh
from jax_bvh.ops import raster, raster_triton, ray_sweep, traverse
from jax_bvh.types import Rays
from jax_bvh.utils import camera, scenes

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _needs_gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")


def _soup(n=150, seed=11):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1.5, 1.5, (n, 1, 3)).astype(np.float32)
    return base + rng.uniform(-0.3, 0.3, (n, 3, 3)).astype(np.float32)


def _assert_same_hits(hit, ref, rtol, atol=0.0):
    """Same hit mask; t within rtol; another prim only where t ties."""
    pk, po = np.asarray(hit.prim_idx), np.asarray(ref.prim_idx)
    tk, to = np.asarray(hit.t), np.asarray(ref.t)
    np.testing.assert_array_equal(pk >= 0, po >= 0)
    both = pk >= 0
    np.testing.assert_allclose(tk[both], to[both], rtol=rtol, atol=atol)
    diff = both & (pk != po)
    np.testing.assert_allclose(tk[diff], to[diff], rtol=rtol, atol=atol)


def _kernel_vs_xla_engine(tris_np):
    tris = jnp.asarray(tris_np)
    tr, cam = scenes.preset("cornellbox")
    rays = camera.generate_rays(cam, 128, 96)
    scene = raster.pack_raster(lbvh.build_two_pass(tris), tris, leaf_size=16)
    hit, _c, ovf = raster_triton.render_raster_triton(scene, rays, tr, 128, 96)
    ref, _c, ovf_x = raster.render_raster_xla(scene, rays, tr, 128, 96)
    assert not bool(ovf) and not bool(ovf_x)
    # both sides may contract multiply-adds into FMAs differently
    _assert_same_hits(hit, ref, rtol=1e-5)


def test_compiled_kernel_matches_xla_engine_cornellbox():
    _kernel_vs_xla_engine(scenes.cornellbox())


def test_compiled_kernel_matches_xla_engine_soup():
    _kernel_vs_xla_engine(_soup())


def test_compiled_kernel_matches_interpret_mode():
    tris = jnp.asarray(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    rays = camera.generate_rays(cam, 64, 64)
    scene = raster.pack_raster(lbvh.build_two_pass(tris), tris, leaf_size=8)
    hit, _c, _o = raster_triton.render_raster_triton(scene, rays, tr, 64, 64)
    ref, _c, _o = raster_triton.render_raster_triton(
        scene, rays, tr, 64, 64, interpret=True
    )
    _assert_same_hits(hit, ref, rtol=1e-5)


def test_sweep_engine_matches_wavefront():
    tris = jnp.asarray(_soup())
    bvh = lbvh.build_two_pass(tris)
    scene = raster.pack_raster(bvh, tris, leaf_size=16)
    tr, _ = scenes.preset("cornellbox")
    rng = np.random.default_rng(11)
    o = rng.uniform(-2.0, 2.0, (2000, 3)).astype(np.float32)
    d = rng.normal(size=(2000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(origin=jnp.asarray(o), direction=jnp.asarray(d),
                tmin=jnp.zeros((2000,), jnp.float32),
                tmax=jnp.full((2000,), 3.4e38, jnp.float32))
    hit, _c, ovf = ray_sweep.trace_rays(scene, rays, tr, cand_cap=64)
    ref, _ = traverse.traverse_bvh2(bvh, tris, rays, tr, variant="speculative")
    assert not bool(ovf)
    # Plücker products reassociate the wavefront engine's arithmetic
    _assert_same_hits(hit, ref, rtol=1e-3, atol=1e-3)
