"""Persistent XLA compilation cache placement for the entry-point scripts.

The scripts (chip_smoke.py, bench*.py, examples/*/run.py) call
``enable_compile_cache()`` once before they compile anything, so a second
run of the same program on the same device reuses the compiled kernels.
"""

import os

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def enable_compile_cache():
    """Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this sets nothing. Otherwise the cache goes to the fixed
    ``<repo>/.jax_cache`` — a fixed path, because the path is part of the
    cache key and a directory that moves never hits. Returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
