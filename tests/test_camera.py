"""Ray-generation RNG: TEA/LCG jitter vs an independent numpy oracle.

The reference carries this plumbing disabled (`isMultiSamples=false`,
`src/CommonBlocksKernel.h:401-446`); `jitter=True` must
bit-match the tea<16> + lcg sequence, and `jitter=False` must reproduce the
0.5-centered rays exactly.
"""
import numpy as np

import jax.numpy as jnp

from jax_bvh.utils import camera, scenes


def _tea16_np(val0: np.ndarray, val1: int) -> np.ndarray:
    v0 = val0.astype(np.uint32)
    v1 = np.full_like(v0, val1, dtype=np.uint32)
    s0 = np.uint32(0)
    with np.errstate(over="ignore"):
        for _ in range(16):
            s0 = np.uint32(s0 + 0x9E3779B9)
            v0 = v0 + (
                (((v1 << np.uint32(4)) + np.uint32(0xA341316C)) ^ (v1 + s0))
                ^ ((v1 >> np.uint32(5)) + np.uint32(0xC8013EA4))
            )
            v1 = v1 + (
                (((v0 << np.uint32(4)) + np.uint32(0xAD90777D)) ^ (v0 + s0))
                ^ ((v0 >> np.uint32(5)) + np.uint32(0x7E95761E))
            )
    return v0


def _lcg_randf_np(seed: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        seed = np.uint32(1103515245) * seed + np.uint32(12345)
    return (seed & np.uint32(0x00FFFFFF)).astype(np.float32) / np.float32(
        0x01000000
    )


def test_tea_lcg_matches_numpy_oracle():
    pix = np.arange(4096, dtype=np.uint32) * 7919 + 13
    v0, _ = camera.tea(jnp.asarray(pix), 0)
    np.testing.assert_array_equal(np.asarray(v0), _tea16_np(pix, 0))
    f, _ = camera.lcg_randf(jnp.asarray(_tea16_np(pix, 0)))
    np.testing.assert_array_equal(np.asarray(f), _lcg_randf_np(_tea16_np(pix, 0)))
    fn = np.asarray(f)
    assert fn.min() >= 0.0 and fn.max() < 1.0
    # jitter is actually pixel-varying
    assert len(np.unique(fn)) > 4000


def test_jittered_rays_match_manual_offsets():
    _tr, cam = scenes.preset("cornellbox")
    w, h = 16, 8
    rays_j = camera.generate_rays(cam, w, h, jitter=True)
    rays_c = camera.generate_rays(cam, w, h, jitter=False)

    gx, gy = np.meshgrid(np.arange(w), np.arange(h), indexing="ij")
    pix = (gx + gy * w).reshape(-1).astype(np.uint32)
    off = _lcg_randf_np(_tea16_np(pix, 0))

    # recompute the jittered directions with the numpy offsets through the
    # same math (the reference uses ONE offset for both axes)
    sensor_x = 0.024 * (w / float(h))
    sensor_y = 0.024
    px = (gx.reshape(-1) + off) / w - 0.5
    py = (gy.reshape(-1) + off) / h - 0.5
    d = np.stack(
        [
            px * sensor_x,
            py * sensor_y,
            np.full_like(px, sensor_y / (2.0 * np.tan(float(cam.fov) / 2.0))),
        ],
        axis=-1,
    ).astype(np.float32)
    from jax_bvh.ops import aabb as A

    hol = np.asarray(A.qt_rotate(cam.quat, jnp.array([1.0, 0, 0], jnp.float32)))
    up = np.asarray(A.qt_rotate(cam.quat, jnp.array([0.0, -1, 0], jnp.float32)))
    view = np.asarray(A.qt_rotate(cam.quat, jnp.array([0.0, 0, -1], jnp.float32)))
    dirs = d[:, 0:1] * hol + d[:, 1:2] * up + d[:, 2:3] * view
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    target = np.asarray(cam.eye) + dirs * float(cam.far)
    want = target / np.linalg.norm(target, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        np.asarray(rays_j.direction), want, rtol=2e-6, atol=2e-6
    )
    # and it differs from the centered rays
    assert not np.allclose(np.asarray(rays_j.direction),
                           np.asarray(rays_c.direction))
