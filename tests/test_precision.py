"""bf16 matmul-precision mode: values stay close to f32, flag restores."""

import numpy as np

from tinynn_autograd_tpu import Tensor
from tinynn_autograd_tpu.ops import kernels


def test_bf16_matmul_mode_close_to_f32():
    rng = np.random.RandomState(0)
    a = rng.randn(64, 32).astype(np.float32)
    b = rng.randn(32, 16).astype(np.float32)
    exact = a @ b
    assert kernels.matmul_precision() == "f32"
    try:
        kernels.set_matmul_precision("bf16")
        ta = Tensor(a, requires_grad=True)
        out = ta @ Tensor(b)
        np.testing.assert_allclose(out.numpy(), exact, rtol=3e-2, atol=1e-1)
        out.backward(np.ones_like(exact))
        np.testing.assert_allclose(
            np.asarray(ta.grad), np.ones_like(exact) @ b.T,
            rtol=3e-2, atol=1e-1)
    finally:
        kernels.set_matmul_precision("f32")


def test_invalid_precision_rejected():
    import pytest

    with pytest.raises(ValueError):
        kernels.set_matmul_precision("fp8")


def _dot_params(fn, *args):
    import jax

    eqns = [e for e in jax.make_jaxpr(fn)(*args).jaxpr.eqns
            if e.primitive.name == "dot_general"]
    assert eqns
    return eqns[0].params


def test_f32_matmul_states_highest_precision():
    """On a GPU a float32 dot at default precision runs in TF32; the f32
    mode promises reference parity, so every f32 product asks for
    HIGHEST explicitly."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones((8, 4), jnp.float32)
    params = _dot_params(kernels.matmul, a, a.T)
    assert params["precision"] == (jax.lax.Precision.HIGHEST,
                                   jax.lax.Precision.HIGHEST)
    assert kernels.dot_precision(jnp.float32) == jax.lax.Precision.HIGHEST
    assert kernels.dot_precision(jnp.bfloat16) is None


def test_bf16_mode_casts_operands_and_accumulates_f32():
    import jax.numpy as jnp

    a = jnp.ones((8, 4), jnp.float32)
    try:
        kernels.set_matmul_precision("bf16")
        params = _dot_params(kernels.matmul, a, a.T)
        out = kernels.matmul(a, a.T)
    finally:
        kernels.set_matmul_precision("f32")
    assert params["preferred_element_type"] == jnp.float32
    assert out.dtype == jnp.float32


def test_attention_twin_states_highest_precision():
    """The attention XLA twin's f32 einsums state HIGHEST like matmul."""
    import jax
    import jax.numpy as jnp

    from tinynn_autograd_tpu.ops import attention

    q = jnp.ones((1, 2, 8, 4), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda q: attention.mha_fwd(
        q, q, q, causal=True, impl="xla"))(q)
    dots = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    for e in dots:
        assert e.params["precision"] == (jax.lax.Precision.HIGHEST,
                                         jax.lax.Precision.HIGHEST)


def test_f32_decode_traces_at_highest_precision():
    """generate() traces its f32 decode program under HIGHEST, so on a
    GPU the decode agrees with the f32 training forward."""
    import importlib

    import jax

    from tinynn_autograd_tpu.models import build_tiny_llama

    gen = importlib.import_module("tinynn_autograd_tpu.models.generate")
    net = build_tiny_llama(vocab=8, dim=16, heads=2, depth=1)
    net.init((1, 4))
    cfg, _params = gen._extract_any(net, 1, 4, 2)
    with gen._matmul_precision(cfg):
        assert jax.config.jax_default_matmul_precision == "highest"
    cfg_bf16, _ = gen._extract_any(net, 1, 4, 2, dtype="bfloat16")
    with gen._matmul_precision(cfg_bf16):
        assert jax.config.jax_default_matmul_precision is None
