"""The persistent compile cache: `JAX_COMPILATION_CACHE_DIR` wins, else a
fixed `.jax_cache/` in the checkout."""
import os

import jax
import pytest

from jax_bvh.config import use_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    use_compile_cache()
    assert jax.config.jax_compilation_cache_dir == os.path.join(ROOT, ".jax_cache")


def test_honours_environment(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    use_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)
