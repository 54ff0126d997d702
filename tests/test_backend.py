"""The one backend predicate and the compile-cache helper."""

import os

import jax
import jax.numpy as jnp
import pytest

from anatomix_tpu import backend


@pytest.mark.parametrize(
    "name,expected", [("cpu", "cpu"), ("gpu", "gpu"), ("cuda", "gpu")]
)
def test_platform_maps_supported_backends(monkeypatch, name, expected):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: name)
    assert backend.platform() == expected


@pytest.mark.parametrize("name", ["tpu", "rocm", "METAL"])
def test_platform_rejects_other_backends(monkeypatch, name):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX backend"):
        backend.platform()


@pytest.mark.parametrize(
    "name,dtype,expected",
    [
        ("gpu", jnp.bfloat16, "cudnn"),
        ("gpu", jnp.float16, "cudnn"),
        ("gpu", jnp.float32, "xla"),
        ("cpu", jnp.bfloat16, "xla"),
    ],
)
def test_attention_implementation(monkeypatch, name, dtype, expected):
    monkeypatch.setattr(backend.jax, "default_backend", lambda: name)
    assert backend.attention_implementation(dtype) == expected


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_repo_cache(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert backend.compile_cache_dir() == os.path.join(repo, ".jax_cache")


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert backend.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
