"""The persistent compile-cache helper (utils/compile_cache.py)."""

import jax

from lobpcg_tpu.utils import compile_cache


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        want = compile_cache.CACHE_DIR
        assert got == str(want) == jax.config.jax_compilation_cache_dir
        assert want.name == ".jax_cache"
        assert (want.parent / "lobpcg_tpu").is_dir()  # the checkout root
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
