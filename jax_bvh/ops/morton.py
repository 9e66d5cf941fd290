"""Morton code computation (plain 30-bit and HIPRT-style extended).

Vectorized equivalents of the device encoders in
`src/CommonBlocksKernel.h:139-398`. The extended code's
axis-ordering decisions depend only on the (scalar) scene extent, so they are
computed once as traced scalars; the per-primitive bit interleaves are pure
uint32 VPU ops over the whole primitive array.
"""
from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32


def _spread2(v):
    """16 -> 32 bit spread, `morton2D` (`CommonBlocksKernel.h:139-147`)."""
    v = v & U32(0x0000FFFF)
    v = (v ^ (v << 8)) & U32(0x00FF00FF)
    v = (v ^ (v << 4)) & U32(0x0F0F0F0F)
    v = (v ^ (v << 2)) & U32(0x33333333)
    v = (v ^ (v << 1)) & U32(0x55555555)
    return v


def _spread3(x):
    """10 -> 30 bit spread, `morton3D` (`CommonBlocksKernel.h:149-156`)."""
    x = (x * U32(0x00010001)) & U32(0xFF0000FF)
    x = (x * U32(0x00000101)) & U32(0x0F00F00F)
    x = (x * U32(0x00000011)) & U32(0xC30C30C3)
    x = (x * U32(0x00000005)) & U32(0x49249249)
    return x


def morton30_cols(nx, ny, nz):
    """Plain 30-bit Morton code from normalized [0,1) coordinate columns,
    `computeMortonCode` (`CommonBlocksKernel.h:361-372`)."""
    def q(p):
        return jnp.clip(p * 1024.0, 0.0, 1023.0).astype(U32)

    return _spread3(q(nx)) * U32(4) + _spread3(q(ny)) * U32(2) + _spread3(q(nz))


def morton30(normalized_pos):
    """Array-of-structs wrapper over `morton30_cols` (f32[N,3] -> u32[N])."""
    return morton30_cols(
        normalized_pos[:, 0], normalized_pos[:, 1], normalized_pos[:, 2]
    )


def _axis_order(ext):
    """Sorted axis order (largest extent first) + prebit counts: the decision
    tree at `CommonBlocksKernel.h:167-250`, collapsed into scalar selects.

    Returns (start_axis i32[3], num_prebits i32[3]): num_prebits[0] =
    ilog2(e0/e1), [1] = ilog2(e1/e2), [2] = ilog2(e0/e2) where e0>=e1>=e2 are
    the sorted extents (C float->int truncation; ratios >= 1 so it's floor).
    """
    x, y, z = ext[0], ext[1], ext[2]
    xy = x < y
    xz = x < z
    yz = y < z
    # The six permutations exactly as the reference's nested ifs resolve them.
    zyx = xy & xz & yz
    yzx = xy & xz & (~yz)
    yxz = xy & (~xz)
    zxy = (~xy) & yz & xz
    xzy = (~xy) & yz & (~xz)
    xyz = (~xy) & (~yz)
    cases = [zyx, yzx, yxz, zxy, xzy, xyz]
    a0 = jnp.select(cases, [2, 1, 1, 2, 0, 0], 0)
    a1 = jnp.select(cases, [1, 2, 0, 0, 2, 1], 0)
    a2 = jnp.select(cases, [0, 0, 2, 1, 1, 2], 0)
    start_axis = jnp.stack([a0, a1, a2]).astype(jnp.int32)

    def ilog2_ratio(a, b):
        safe = (b > 0) & (a > 0)
        r = jnp.where(safe, a / jnp.where(b > 0, b, 1.0), 1.0)
        return jnp.floor(jnp.log2(r)).astype(jnp.int32)

    e0 = ext[a0]
    e1 = ext[a1]
    e2 = ext[a2]
    num_prebits = jnp.stack(
        [ilog2_ratio(e0, e1), ilog2_ratio(e1, e2), ilog2_ratio(e0, e2)]
    )
    return start_axis, num_prebits


def extended_morton30(normalized_pos, scene_extent):
    """HIPRT-style extended Morton code, `computeExtendedMortonCode`
    (`CommonBlocksKernel.h:159-359`).

    Spends extra leading bits on the dominant axes (by extent ratio) before
    falling back to 2D/3D interleave. All axis/bit-budget decisions are scalar
    (uniform over the scene); per-primitive work is pure u32 bit math.
    normalized_pos: f32[N,3], scene_extent: f32[3] -> u32[N].
    """
    return extended_morton30_cols(
        normalized_pos[:, 0],
        normalized_pos[:, 1],
        normalized_pos[:, 2],
        scene_extent,
    )


def extended_morton30_cols(px, py, pz, scene_extent):
    """Column form of `extended_morton30` (axis selection via dense selects
    instead of dynamic [n,3] column extraction)."""
    num_morton_bits = 30
    start_axis, pre = _axis_order(scene_extent)
    swap = pre[2] - (pre[0] + pre[1])

    pre_x = jnp.minimum(pre[0], num_morton_bits)
    pre_y = jnp.minimum(pre[1] * 2, num_morton_bits - pre_x) // 2
    prebits_sum = pre_x + pre_y * 2
    at_cap = prebits_sum == num_morton_bits
    swap = jnp.where(at_cap, 0, swap)
    prebits_sum = jnp.where(at_cap, prebits_sum, prebits_sum + swap)

    ext_smallest = scene_extent[start_axis[2]]
    bits_z = jnp.where(
        ext_smallest != 0.0,
        jnp.maximum(0, (num_morton_bits - prebits_sum) // 3),
        0,
    )
    use_swap = swap > 0
    bits_x = jnp.where(
        use_swap,
        jnp.maximum(
            0,
            (num_morton_bits - bits_z - prebits_sum) // 2 + pre_y + pre_x + 1,
        ),
        0,
    )
    bits_y = jnp.where(
        use_swap,
        num_morton_bits - bits_x - bits_z,
        jnp.maximum(0, (num_morton_bits - bits_z - prebits_sum) // 2 + pre_y),
    )
    bits_x = jnp.where(use_swap, bits_x, num_morton_bits - bits_y - bits_z)

    # Per-axis quantized codes: scalar bit budgets, vector positions.
    def axis_code(p, nbits):
        scale = (U32(1) << nbits.astype(U32)).astype(jnp.float32)
        return jnp.minimum(jnp.maximum(p * scale, 0.0), scale - 1.0).astype(U32)

    def pick(axis):
        return jnp.where(axis == 0, px, jnp.where(axis == 1, py, pz))

    code_x = axis_code(pick(start_axis[0]), bits_x)
    code_y = axis_code(pick(start_axis[1]), bits_y)
    code_z = axis_code(pick(start_axis[2]), bits_z)

    have_pre = prebits_sum > 0
    ubx = bits_x.astype(U32)
    uby = bits_y.astype(U32)
    ubz = bits_z.astype(U32)
    upx = pre_x.astype(U32)
    upy = pre_y.astype(U32)

    # --- prebit path (CommonBlocksKernel.h:289-338), computed unconditionally
    # and masked at the end (scalars only differ; vectors are cheap).
    bx1 = ubx - upx  # numBits.x after taking x prebits
    m = (code_x & (((U32(1) << upx) - U32(1)) << bx1)) >> bx1
    m = m << (upy * U32(2))
    bx2 = bx1 - upy
    by1 = uby - upy
    t0 = _spread2((code_x & (((U32(1) << upy) - U32(1)) << bx2)) >> bx2)
    t1 = _spread2((code_y & (((U32(1) << upy) - U32(1)) << by1)) >> by1)
    m = m | (t0 * U32(2) + t1)

    bx3 = jnp.where(use_swap & have_pre, bx2 - U32(1), bx2)
    m_sw = (m << U32(1)) | ((code_x & (U32(1) << bx3)) >> bx3)
    m = jnp.where(use_swap, m_sw, m)
    m = m << (bx3 + by1 + ubz)

    cx_pre = code_x & ((U32(1) << bx3) - U32(1))
    cy_pre = code_y & ((U32(1) << by1) - U32(1))
    delta0 = jnp.where(use_swap, by1 - bx3, bx3 - by1)
    delta1 = jnp.where(use_swap, by1 - ubz, bx3 - ubz)
    cx_pre = jnp.where(use_swap, cx_pre << delta0, cx_pre)
    cy_pre = jnp.where(use_swap, cy_pre, cy_pre << delta0)
    cz_pre = code_z << delta1

    # Select prebit vs plain path.
    cx = jnp.where(have_pre, cx_pre, code_x)
    cy = jnp.where(have_pre, cy_pre, code_y)
    cz = jnp.where(have_pre, cz_pre, code_z)
    m = jnp.where(have_pre, m, U32(0))
    delta0 = jnp.where(have_pre, delta0, U32(0))
    delta1 = jnp.where(have_pre, delta1, U32(0))

    # --- final interleave (CommonBlocksKernel.h:340-356)
    tail_2d = _spread2(cx) * U32(2) + _spread2(cy)
    sx = jnp.where(cx > 0, _spread3(cx), U32(0))
    sy = jnp.where(cy > 0, _spread3(cy), U32(0))
    sz = jnp.where(cz > 0, _spread3(cz), U32(0))
    tail_3d = jnp.where(
        use_swap, sy * U32(4) + sx * U32(2) + sz, sx * U32(4) + sy * U32(2) + sz
    ) >> (delta0 + delta1)
    tail = jnp.where(bits_z == 0, tail_2d, tail_3d)
    return m | tail


def normalize_centroids(centroids, scene_min, scene_extent):
    """Centroid -> [0,1)^3, matching `CalculateMortonCodes`
    (`CommonBlocksKernel.h:374-398`)."""
    safe = jnp.where(scene_extent > 0, scene_extent, 1.0)
    return (centroids - scene_min) / safe
