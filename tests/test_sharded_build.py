"""Sharded single-scene build vs the single-device builder: bit-identical
trees on the 8-device virtual CPU mesh (SURVEY §5 'long-context' axis)."""
from __future__ import annotations

import numpy as np
import pytest

pytestmark = pytest.mark.slow
import jax
import jax.numpy as jnp

from jax_bvh.models import lbvh
from jax_bvh.parallel import sharded_build
from jax_bvh.parallel.sharded import default_mesh
from jax_bvh.utils import scenes, validate


def _compare(tris_np, p=8):
    mesh = default_mesh(p)
    tris = jnp.asarray(tris_np)
    n = int(tris.shape[0])
    sb = sharded_build.build_single_pass_sharded(mesh, tris)
    assert not bool(sb.overflow), "routing capacity overflowed"
    got = sharded_build.to_bvh2(sb, n)
    want = lbvh.build_single_pass(tris)
    np.testing.assert_array_equal(np.asarray(got.left), np.asarray(want.left))
    np.testing.assert_array_equal(np.asarray(got.right), np.asarray(want.right))
    np.testing.assert_array_equal(np.asarray(got.root), np.asarray(want.root))
    np.testing.assert_array_equal(
        np.asarray(got.node_min), np.asarray(want.node_min)
    )
    np.testing.assert_array_equal(
        np.asarray(got.node_max), np.asarray(want.node_max)
    )
    assert validate.check_bvh2_correctness(got, n)
    assert validate.check_root_aabb(got)
    return got


def test_sharded_matches_single_device_random():
    rng = np.random.default_rng(42)
    n = 4096
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    tris = (base + rng.normal(0, 0.4, size=(n, 3, 3))).astype(np.float32)
    _compare(tris)


def test_sharded_matches_single_device_duplicates():
    """Heavy duplicate Morton codes: the index-augmented tie-break and the
    pad-boundary sentinel must survive sharding."""
    rng = np.random.default_rng(7)
    n = 2048
    cells = rng.integers(0, 4, size=(n, 1, 3)).astype(np.float32)
    tris = cells + rng.normal(0, 0.01, size=(n, 3, 3)).astype(np.float32)
    _compare(tris)


def test_sharded_matches_cornellbox_tiled():
    """Real mesh data (cornellbox replicated into a grid)."""
    base = np.asarray(scenes.cornellbox(), np.float32)
    reps = int(np.ceil(2048 / base.shape[0]))
    offs = np.arange(reps, dtype=np.float32)[:, None, None, None] * 3.0
    tris = (base[None] + offs).reshape(-1, 3, 3)[:2048]
    _compare(tris)


def test_sharded_overflow_flag():
    """When a shard has more long-range nodes than the routing capacity the
    build must raise its honesty flag instead of silently corrupting."""
    rng = np.random.default_rng(3)
    n = 2048
    base = rng.uniform(-10, 10, size=(n, 1, 3))
    tris = (base + rng.normal(0, 0.4, size=(n, 3, 3))).astype(np.float32)
    mesh = default_mesh(8)
    sb = sharded_build.build_single_pass_sharded(
        mesh, jnp.asarray(tris), route_cap=4
    )
    assert bool(sb.overflow)


@pytest.mark.slow
def test_sharded_1m_scene():
    """The VERDICT item-8 acceptance case: 1M-tri scene sharded 8 ways."""
    tris = np.asarray(scenes.sponza_like(1 << 20))
    tris = tris[: (tris.shape[0] // 8) * 8]  # scene gen rounds per-object
    _compare(tris)
