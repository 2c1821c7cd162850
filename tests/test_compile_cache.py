"""The persistent compilation cache follows JAX_COMPILATION_CACHE_DIR when
it is set, and the fixed <checkout>/.jax_cache otherwise."""

import os

import jax
import pytest

from pathtracer_tpu.utils import compile_cache


@pytest.fixture()
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_is_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(root, ".jax_cache")
    assert compile_cache.cache_dir() == expected
    assert compile_cache.enable_compile_cache() == expected
    assert jax.config.jax_compilation_cache_dir == expected
