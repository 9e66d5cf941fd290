"""Morton encoders vs an independent scalar oracle (python ints), including
the extended code's axis-weighting decisions (`CommonBlocksKernel.h:159-359`).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from jax_bvh.ops import morton


def _spread3(x):
    x = (x * 0x00010001) & 0xFF0000FF
    x = (x * 0x00000101) & 0x0F00F00F
    x = (x * 0x00000011) & 0xC30C30C3
    x = (x * 0x00000005) & 0x49249249
    return x & 0xFFFFFFFF


def _spread2(v):
    v &= 0x0000FFFF
    v = (v ^ (v << 8)) & 0x00FF00FF
    v = (v ^ (v << 4)) & 0x0F0F0F0F
    v = (v ^ (v << 2)) & 0x33333333
    v = (v ^ (v << 1)) & 0x55555555
    return v & 0xFFFFFFFF


def _morton30_scalar(p):
    q = [min(max(c * 1024.0, 0.0), 1023.0) for c in p]
    return (_spread3(int(q[0])) * 4 + _spread3(int(q[1])) * 2 + _spread3(int(q[2]))) & 0xFFFFFFFF


def _ext_scalar(pos, ext):
    """Scalar oracle for the extended Morton code (30 bits): sort axes by
    extent, spend prebits on dominant axes per the extent log-ratios, then
    2D/3D-interleave the remainder."""
    NB = 30
    order = sorted(range(3), key=lambda a: -ext[a])
    e0, e1, e2 = (ext[a] for a in order)

    def il2(a, b):
        if a <= 0 or b <= 0:
            return 0
        return int(np.floor(np.log2(a / b)))

    pre = [il2(e0, e1), il2(e1, e2), il2(e0, e2)]
    swap = pre[2] - (pre[0] + pre[1])
    pre_x = min(pre[0], NB)
    pre_y = min(pre[1] * 2, NB - pre_x) // 2
    psum = pre_x + pre_y * 2
    if psum != NB:
        psum += swap
    else:
        swap = 0
    bz = max(0, (NB - psum) // 3) if e2 != 0 else 0
    if swap > 0:
        bx = max(0, (NB - bz - psum) // 2 + pre_y + pre_x + 1)
        by = NB - bx - bz
    else:
        by = max(0, (NB - bz - psum) // 2 + pre_y)
        bx = NB - by - bz

    def axis_code(p, nb):
        s = 1 << nb
        return min(int(max(p * s, 0.0)), s - 1)

    cx = axis_code(pos[order[0]], bx)
    cy = axis_code(pos[order[1]], by)
    cz = axis_code(pos[order[2]], bz)

    code = 0
    d0 = d1 = 0
    if psum > 0:
        bx -= pre_x
        code = (cx >> bx) & ((1 << pre_x) - 1)
        code <<= pre_y * 2
        bx -= pre_y
        by -= pre_y
        t0 = _spread2((cx >> bx) & ((1 << pre_y) - 1))
        t1 = _spread2((cy >> by) & ((1 << pre_y) - 1))
        code |= t0 * 2 + t1
        if swap > 0:
            code <<= 1
            bx -= 1
            code |= (cx >> bx) & 1
        code <<= bx + by + bz
        cx &= (1 << bx) - 1
        cy &= (1 << by) - 1
        if swap > 0:
            d0 = by - bx
            cx <<= d0
            d1 = by - bz
            cz <<= d1
        else:
            d0 = bx - by
            cy <<= d0
            d1 = bx - bz
            cz <<= d1
    if bz == 0:
        code |= _spread2(cx) * 2 + _spread2(cy)
    else:
        sx = _spread3(cx) if cx > 0 else 0
        sy = _spread3(cy) if cy > 0 else 0
        sz = _spread3(cz) if cz > 0 else 0
        tail = (sy * 4 + sx * 2 + sz) if swap > 0 else (sx * 4 + sy * 2 + sz)
        code |= tail >> (d0 + d1)
    return code & 0xFFFFFFFF


@pytest.mark.parametrize("seed", range(3))
def test_morton30_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    pos = rng.random((200, 3)).astype(np.float32)
    got = np.asarray(morton.morton30(jnp.asarray(pos)))
    want = [_morton30_scalar(p) for p in pos.astype(np.float64)]
    assert got.tolist() == want


EXTENTS = [
    (1.0, 1.0, 1.0),
    (10.0, 1.0, 0.1),
    (1.0, 100.0, 1.0),
    (0.5, 0.5, 64.0),
    (3.0, 2.0, 0.0),  # flat scene (zero extent axis)
    (1e4, 1.0, 1.0),
]


@pytest.mark.parametrize("ext", EXTENTS, ids=range(len(EXTENTS)))
def test_extended_morton_matches_oracle(ext):
    rng = np.random.default_rng(42)
    pos = rng.random((100, 3)).astype(np.float32)
    got = np.asarray(
        morton.extended_morton30(jnp.asarray(pos), jnp.asarray(ext, jnp.float32))
    )
    want = [_ext_scalar(p, np.asarray(ext, np.float64)) for p in pos.astype(np.float64)]
    assert got.tolist() == want


def test_extended_morton_is_30bit():
    rng = np.random.default_rng(0)
    pos = rng.random((1000, 3)).astype(np.float32)
    for ext in EXTENTS:
        got = np.asarray(
            morton.extended_morton30(jnp.asarray(pos), jnp.asarray(ext, jnp.float32))
        )
        assert (got < (1 << 30)).all()


@pytest.mark.slow
def test_extended_morton_orders_dominant_axis_first():
    """The extended code spends its leading bits on the dominant axis:
    on a stretched scene the code order must follow x for points that only
    differ in x by large margins."""
    ext = jnp.asarray([300.0, 1.0, 1.0], jnp.float32)
    xs = np.linspace(0.01, 0.99, 64)
    pos = np.stack([xs, np.full(64, 0.7), np.full(64, 0.3)], axis=1).astype(np.float32)
    codes = np.asarray(morton.extended_morton30(jnp.asarray(pos), ext))
    assert (np.diff(codes.astype(np.int64)) > 0).all()

    # and a valid BVH still comes out either way
    from tests.conftest import random_tris
    from jax_bvh.models import lbvh
    from jax_bvh.utils import validate

    rng = np.random.default_rng(3)
    tris = random_tris(rng, 500, spread=1.0, size=0.05)
    tris[:, :, 0] *= 300.0
    for use_ext in (True, False):
        bvh = lbvh.build_two_pass(tris, use_extended=use_ext)
        assert validate.check_bvh2_correctness(bvh, 500)
