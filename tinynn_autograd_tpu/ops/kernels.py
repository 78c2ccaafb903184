"""The matmul every tape primitive routes through, and its precision mode.

The FLOP sink of the whole framework is matmul (forward + both VJPs of
``dot_`` — the reference spends its time in np.matmul at core/ops.py:151,
157, 160). ``matmul`` hands it to XLA, which on the GPU calls cuBLAS /
cuBLASLt and autotunes the choice; the precision mode decides what the
operands are:

- ``"f32"`` (default): float32 operands at ``Precision.HIGHEST``, so the
  GPU does not silently round them to TF32 — exact reference parity.
- ``"bf16"``: operands cast to bfloat16 for the tensor cores' fast path,
  accumulated in float32.
"""

import jax
import jax.numpy as jnp

_MATMUL_PRECISION = "f32"


def set_matmul_precision(mode):
    """mode: "f32" | "bf16". Affects newly traced programs."""
    global _MATMUL_PRECISION
    if mode not in ("f32", "bf16"):
        raise ValueError(mode)
    _MATMUL_PRECISION = mode


def matmul_precision():
    return _MATMUL_PRECISION


def dot_precision(dtype):
    """The ``precision=`` a float32 product states: HIGHEST (no TF32
    rounding) for float32 operands, the default for narrower ones."""
    if jnp.dtype(dtype) == jnp.float32:
        return jax.lax.Precision.HIGHEST
    return None


def _cast_inputs(a, b):
    if (_MATMUL_PRECISION == "bf16"
            and jnp.issubdtype(a.dtype, jnp.floating)
            and jnp.issubdtype(b.dtype, jnp.floating)):
        return a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), jnp.float32
    return a, b, None


def matmul(a, b):
    """Matmul used by the ``dot_`` primitive and its VJPs. Semantics are
    numpy.matmul, with float32 accumulation always."""
    a, b, forced_out = _cast_inputs(a, b)
    out_t = forced_out if forced_out is not None else _acc_type(a, b)
    return jnp.matmul(a, b, preferred_element_type=out_t,
                      precision=dot_precision(jnp.result_type(a, b)))


def _acc_type(a, b):
    out = jnp.promote_types(a.dtype, b.dtype)
    if out == jnp.bfloat16 or out == jnp.float16:
        return jnp.float32
    return None
