"""Boundary-ordered window refit vs a brute-force range min/max."""
import jax.numpy as jnp
import numpy as np
import pytest

from jax_bvh.ops import refit


def _mk(rng, n, radius):
    leaf_min = rng.random((n, 3), dtype=np.float32)
    leaf_max = leaf_min + 0.05 + rng.random((n, 3), dtype=np.float32)
    m = n - 1
    # boundary-ordered ranges: first <= i < i+1 <= last, mixed lengths
    i = np.arange(m)
    span_l = rng.integers(0, 3 * radius, m)
    span_r = rng.integers(0, 3 * radius, m)
    first = np.maximum(i - span_l, 0).astype(np.int32)
    last = np.minimum(i + 1 + span_r, n - 1).astype(np.int32)
    return leaf_min, leaf_max, first, last


def _brute(leaf_min, leaf_max, first, last):
    mn = np.stack([leaf_min[f:l + 1].min(axis=0) for f, l in zip(first, last)])
    mx = np.stack([leaf_max[f:l + 1].max(axis=0) for f, l in zip(first, last)])
    return mn, mx


@pytest.mark.parametrize("n", [64, 257, 1024])
@pytest.mark.parametrize("radius", [16, 24])
def test_window_refit_matches_brute_force(n, radius):
    rng = np.random.default_rng(n + radius)
    leaf_min, leaf_max, first, last = _mk(rng, n, radius)
    packed_t = jnp.concatenate(
        [jnp.asarray(leaf_min), -jnp.asarray(leaf_max)], axis=1
    ).T
    out = np.asarray(
        refit.refit_anchored_packed(
            packed_t, jnp.asarray(first), jnp.asarray(last), radius
        )
    )
    mn, mx = _brute(leaf_min, leaf_max, first, last)
    np.testing.assert_array_equal(out[:3].T, mn)
    np.testing.assert_array_equal(-out[3:].T, mx)


def test_refit_anchored_matches_brute_force():
    """The row-major wrapper at its default radius, including ranges that
    take the long-node table path."""
    rng = np.random.default_rng(7)
    n = 500
    leaf_min, leaf_max, first, last = _mk(rng, n, 16)
    mn, mx = refit.refit_anchored(
        jnp.asarray(leaf_min), jnp.asarray(leaf_max),
        jnp.asarray(first), jnp.asarray(last),
    )
    want_mn, want_mx = _brute(leaf_min, leaf_max, first, last)
    np.testing.assert_array_equal(np.asarray(mn), want_mn)
    np.testing.assert_array_equal(np.asarray(mx), want_mx)


def test_refit_degenerate_long_ranges_take_full_table():
    """Every range longer than the window (caterpillar Morton runs): the
    long count exceeds the static budget and the exact full-table path
    answers."""
    rng = np.random.default_rng(3)
    n = 400
    leaf_min = rng.random((n, 3), dtype=np.float32)
    leaf_max = leaf_min + 0.1
    i = np.arange(n - 1)
    first = np.where(i < n // 2, 0, i - n // 3).clip(0).astype(np.int32)
    last = np.where(i < n // 2, i + n // 3, n - 1).clip(max=n - 1).astype(np.int32)
    last = np.maximum(last, i + 1).astype(np.int32)
    first = np.minimum(first, i).astype(np.int32)
    packed_t = jnp.concatenate(
        [jnp.asarray(leaf_min), -jnp.asarray(leaf_max)], axis=1
    ).T
    out = np.asarray(
        refit.refit_anchored_packed(packed_t, jnp.asarray(first), jnp.asarray(last))
    )
    mn, mx = _brute(leaf_min, leaf_max, first, last)
    np.testing.assert_array_equal(out[:3].T, mn)
    np.testing.assert_array_equal(-out[3:].T, mx)
