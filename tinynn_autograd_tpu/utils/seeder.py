"""Global seeding: numpy RNG + a jax PRNG key stream.

Extension of the reference seeder (reference: utils/seeder.py:6-11): under
JAX, randomness is counter-based (threefry keys), so ``random_seed`` both
seeds numpy (host-side shuffling) and resets a global key from which
initializers and dropout split fresh subkeys.
"""

import contextlib

import jax
import numpy as np

_MAX_SEED = 2 ** 32

_state = {"key": None}


def random_seed(seed):
    """Seed numpy and the global jax key stream. Valid range [0, 2**32)."""
    if not (0 <= seed < _MAX_SEED):
        raise ValueError("Seed must be between 0 and 2**32 - 1, got %s" % seed)
    np.random.seed(seed)
    _state["key"] = jax.random.PRNGKey(seed)


def next_key():
    """Split a fresh PRNG subkey off the global stream.

    Auto-seeds from numpy's RNG if ``random_seed`` was never called, so
    unseeded runs are still random but a prior ``np.random.seed`` makes
    them reproducible.
    """
    if _state["key"] is None:
        _state["key"] = jax.random.PRNGKey(int(np.random.randint(0, 2 ** 31)))
    _state["key"], sub = jax.random.split(_state["key"])
    return sub


@contextlib.contextmanager
def scope(seed):
    """Temporarily replace the global key stream with a DEDICATED stream.

    Draws inside the scope come from ``PRNGKey(seed)`` (or the given key)
    and do NOT advance the global stream — so parameter initialization can
    be pinned independently of global draw ORDER. This removes the
    lazy-init footgun where two models built before either trains pull
    different draws from the interleaved global stream::

        with seeder.scope(7):
            net = build_mnist_mlp(); net.init((128, 784))

    Layers also accept ``seed=`` directly (Dense, Conv2D, DenseStack, MoE,
    Embedding, PositionalEmbedding, TransformerBlock), which wraps their
    own parameter draws in this scope.
    """
    prev = _state["key"]
    _state["key"] = (jax.random.PRNGKey(seed)
                     if isinstance(seed, (int, np.integer)) else seed)
    try:
        yield
    finally:
        _state["key"] = prev
