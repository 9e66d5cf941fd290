"""Primary-ray generation (pinhole camera from quaternion + fov).

Vectorized equivalent of `GenerateRays`
(`src/CommonBlocksKernel.h:432-463`), including its 0.024
sensor size and the `normalize(eye + dir*far)` direction quirk, so rendered
images match the reference pixel-for-pixel in layout (flat index =
x * height + y). The TEA/LCG jitter plumbing the reference carries disabled
(`isMultiSamples=false`, `CommonBlocksKernel.h:401-430,439-446`) is
reproduced behind `jitter=` — off by default, bit-matching the reference's
`tea<16>` + `lcg` sequence when on."""
from __future__ import annotations

import jax.numpy as jnp

from ..ops import aabb as A
from ..types import Camera, Rays, FLT_MAX

U32 = jnp.uint32


def tea(val0, val1, rounds: int = 16):
    """TEA hash (`CommonBlocksKernel.h:414-430`): u32 arrays -> (v0, v1)."""
    v0 = val0.astype(U32)
    v1 = jnp.broadcast_to(jnp.asarray(val1, U32), v0.shape)
    s0 = U32(0)
    for _ in range(rounds):
        s0 = s0 + U32(0x9E3779B9)
        v0 = v0 + (
            (((v1 << 4) + U32(0xA341316C)) ^ (v1 + s0))
            ^ ((v1 >> 5) + U32(0xC8013EA4))
        )
        v1 = v1 + (
            (((v0 << 4) + U32(0xAD90777D)) ^ (v0 + s0))
            ^ ((v0 >> 5) + U32(0x7E95761E))
        )
    return v0, v1


def lcg_randf(seed):
    """One LCG step (`CommonBlocksKernel.h:400-412`): returns (f32 in
    [0, 1), advanced seed)."""
    seed = U32(1103515245) * seed + U32(12345)
    return (seed & U32(0x00FFFFFF)).astype(jnp.float32) / jnp.float32(
        0x01000000
    ), seed


def generate_rays(
    cam: Camera, width: int, height: int, jitter: bool = False
) -> Rays:
    x = jnp.arange(width, dtype=jnp.float32)
    y = jnp.arange(height, dtype=jnp.float32)
    gx, gy = jnp.meshgrid(x, y, indexing="ij")  # [W, H]
    gx = gx.reshape(-1)
    gy = gy.reshape(-1)

    sensor_x = 0.024 * (width / float(height))
    sensor_y = 0.024
    if jitter:
        # per-pixel seed = tea<16>(gIdx + gIdy*width, 0).x; ONE randf call
        # shared by both axes (`CommonBlocksKernel.h:443-446`)
        pix = (gx + gy * width).astype(U32)
        seed, _ = tea(pix, 0)
        offset, _ = lcg_randf(seed)
    else:
        offset = 0.5
    px = (gx + offset) / width - 0.5
    py = (gy + offset) / height - 0.5
    d = jnp.stack(
        [
            px * sensor_x,
            py * sensor_y,
            jnp.full_like(px, sensor_y / (2.0 * jnp.tan(cam.fov / 2.0))),
        ],
        axis=-1,
    )

    hol = A.qt_rotate(cam.quat, jnp.array([1.0, 0.0, 0.0], jnp.float32))
    up = A.qt_rotate(cam.quat, jnp.array([0.0, -1.0, 0.0], jnp.float32))
    view = A.qt_rotate(cam.quat, jnp.array([0.0, 0.0, -1.0], jnp.float32))
    dirs = d[:, 0:1] * hol + d[:, 1:2] * up + d[:, 2:3] * view
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)

    n = width * height
    origin = jnp.broadcast_to(cam.eye, (n, 3))
    target = cam.eye + dirs * cam.far
    direction = target / jnp.linalg.norm(target, axis=-1, keepdims=True)
    return Rays(
        origin=origin,
        direction=direction,
        tmin=jnp.zeros(n, jnp.float32),
        tmax=jnp.full(n, FLT_MAX, jnp.float32),
    )
