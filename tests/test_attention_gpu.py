"""The flash-attention kernels as the GPU compiles them (no interpreter):
parity with the XLA twin, forward and backward, with GQA, causal window,
dropout and a ragged length. Card-only: skips elsewhere; run on a card
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import numpy as np
import pytest

import jax.numpy as jnp

from tinynn_autograd_tpu.ops import attention


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.gpu
@pytest.mark.parametrize("t,kw", [
    (1024, dict(causal=True)),
    (1000, dict(causal=True, window=300, dropout_rate=0.1,
                dropout_seed=5)),
    (384, dict(causal=False)),
])
def test_compiled_kernels_match_twin(gpu, t, kw):
    rng = np.random.RandomState(0)
    b, h, hkv, d = 2, 8, 2, 64
    q, do = (jnp.asarray(rng.randn(b, h, t, d), jnp.float32)
             for _ in range(2))
    k, v = (jnp.asarray(rng.randn(b, hkv, t, d), jnp.float32)
            for _ in range(2))
    o_x, lse_x = attention.mha_fwd(q, k, v, impl="xla", **kw)
    o_k, lse_k = attention.mha_fwd(q, k, v, impl="pallas", **kw)
    # f32: TF32x3 dots in the kernels, HIGHEST in the twin
    assert _rel(o_k, o_x) < 1e-4 and _rel(lse_k, lse_x) < 1e-4
    ref = attention.mha_bwd(q, k, v, o_x, lse_x, do, impl="xla", **kw)
    got = attention.mha_bwd(q, k, v, o_x, lse_x, do, impl="pallas", **kw)
    for a, r in zip(got, ref):
        assert _rel(a, r) < 1e-4
