"""Raster engine choice by backend, and the wrappers around the kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax_bvh.models import lbvh
from jax_bvh.ops import raster, raster_triton, traverse
from jax_bvh.utils import camera, scenes


def _scene(leaf=8):
    tris = jnp.asarray(scenes.cornellbox())
    tr, cam = scenes.preset("cornellbox")
    bvh = lbvh.build_two_pass(tris)
    return bvh, tris, tr, cam, raster.pack_raster(bvh, tris, leaf_size=leaf)


def test_raster_engine_on_cpu_is_plain_reference():
    assert jax.default_backend() == "cpu"
    assert raster.raster_engine() == "xla"


def test_raster_engine_on_gpu_is_triton(monkeypatch):
    monkeypatch.setattr(raster.jax, "default_backend", lambda: "gpu")
    assert raster.raster_engine() == "triton"


def test_raster_engine_refuses_other_backends(monkeypatch):
    monkeypatch.setattr(raster.jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="metal"):
        raster.raster_engine()


def test_render_raster_on_gpu_backend_runs_the_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(raster.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        raster_triton, "render_raster_triton",
        lambda *a, **k: calls.append((a, k)) or "kernel",
    )
    assert raster.render_raster(None, None, None, 64, 64) == "kernel"
    assert len(calls) == 1


def test_render_raster_on_cpu_equals_xla_reference():
    _bvh, _tris, tr, cam, scene = _scene()
    rays = camera.generate_rays(cam, 64, 64)
    got = raster.render_raster(scene, rays, tr, 64, 64)
    want = raster.render_raster_xla(scene, rays, tr, 64, 64)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_xla_raster_pads_unaligned_frames():
    """Frames that are not a multiple of the tile pad with edge-replicated
    rays and crop back: same hits as the wavefront engine."""
    bvh, tris, tr, cam, scene = _scene()
    w, h = 72, 40
    rays = camera.generate_rays(cam, w, h)
    hit, counts, ovf = raster.render_raster_xla(scene, rays, tr, w, h)
    assert hit.prim_idx.shape == (w * h,) and counts.shape == (w * h,)
    assert not bool(ovf)
    ref, _ = traverse.traverse_bvh2(bvh, tris, rays, tr, variant="speculative")
    pk, po = np.asarray(hit.prim_idx), np.asarray(ref.prim_idx)
    np.testing.assert_array_equal(pk >= 0, po >= 0)
    both = pk >= 0
    np.testing.assert_allclose(
        np.asarray(hit.t)[both], np.asarray(ref.t)[both], rtol=1e-4
    )


def test_kernel_overflow_flag_fires():
    """An undersized candidate cap raises the overflow flag."""
    _bvh, _tris, tr, cam, scene = _scene()
    rays = camera.generate_rays(cam, 64, 64)
    _hit, _c, ovf = raster_triton.render_raster_triton(
        scene, rays, tr, 64, 64, cand_cap=1, interpret=True
    )
    assert bool(ovf)


def test_coef_table_layout():
    """[T+1, 16, L]: Möller rows of `raster._moller_coefs`, t0 zero for
    padding prims, and an all-zero treelet T that never hits."""
    _bvh, _tris, tr, _cam, scene = _scene(leaf=16)
    eye = jnp.asarray([0.1, 0.2, 3.0], jnp.float32)
    wt = scene.tris_sorted
    table = np.asarray(raster_triton._coef_table(wt, scene.prim_ids, eye, 16))
    nt = wt.shape[0] // 16
    assert table.shape == (nt + 1, 16, 16)
    assert not table[nt].any()
    assert not table[:, 13:].any()
    coefs, t0 = raster._moller_coefs(wt, eye)
    real = np.asarray(scene.prim_ids) >= 0
    np.testing.assert_array_equal(
        table[:nt, :12].transpose(0, 2, 1).reshape(-1, 12),
        np.asarray(coefs).reshape(-1, 12),
    )
    np.testing.assert_array_equal(
        table[:nt, 12].reshape(-1), np.where(real, np.asarray(t0), 0.0)
    )
