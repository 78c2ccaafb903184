"""Compile-cache placement and the device description the measuring
scripts print."""

import subprocess

import jax

from tinynn_autograd_tpu.utils import compile_cache, device


def _restore(prev):
    jax.config.update("jax_compilation_cache_dir", prev)


def test_cache_goes_to_fixed_repo_dir_when_env_unset(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.CACHE_DIR
        assert path.endswith("/.jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # a fixed path: the same on every call, in every process
        assert compile_cache.enable_compile_cache() == path
    finally:
        _restore(prev)


def test_cache_left_to_jax_when_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == prev
    finally:
        _restore(prev)


def test_cache_dir_is_gitignored():
    import os

    root = os.path.dirname(compile_cache.CACHE_DIR)
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_card_line_without_nvidia_smi(monkeypatch):
    def missing(*a, **k):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(subprocess, "run", missing)
    assert device.card_line() == "not available"


def test_describe_names_the_device(monkeypatch):
    monkeypatch.setattr(device, "card_line", lambda: "NVIDIA H100, 700 W")
    info = device.describe()
    assert info["platform"] == jax.devices()[0].platform
    assert info["device_kind"] == jax.devices()[0].device_kind
    assert info["device_count"] == len(jax.devices())
    assert info["card"] == "NVIDIA H100, 700 W"
