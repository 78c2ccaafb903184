"""Differentiable primitives: forward on device + hand-written VJP closures.

Redesign of the reference op set (reference: core/ops.py) for XLA. Each
primitive computes its forward value with XLA-staged jax.numpy calls (the hot
matmul path goes through ``tinynn_autograd_tpu.ops.kernels``, which states
its precision) and registers hand-written VJP closures on the output
Tensor. ``jax.grad`` is NOT used anywhere; reverse-mode is our own tape
(see ``core/tensor.py``).

Broadcasting semantics: every binary VJP funnels through a single
``unbroadcast`` helper that reproduces numpy broadcasting reduction exactly —
sum away leading extra dims, then keepdims-sum size-1 dims (the reference
repeats this pattern inline in every op, reference: core/ops.py:39-55).

Deliberate divergences from the reference (bug fixes, each cited):
- reduce max/min VJP works for ANY axis (reference breaks for non-leading
  axes, reference: core/ops.py:228-229).
- ``getitem_`` accumulates gradients for repeated indices via scatter-add
  (reference last-write-wins, reference: core/ops.py:285-288).
- ``sum_`` supports tuple axes and keepdims (reference: int axis only,
  core/ops.py:252-263).
"""

import builtins

import jax
import jax.numpy as jnp
import numpy as np

from tinynn_autograd_tpu.ops import kernels


def as_tensor(obj):
    from tinynn_autograd_tpu.core.tensor import as_tensor as _as_tensor

    return _as_tensor(obj)


# --------------------------------------------------------------------------
# builders
# --------------------------------------------------------------------------

def build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values):
    """Wrap ``values`` in a Tensor recording VJP edges to requiring inputs
    (reference contract: core/ops.py:12-20)."""
    requires_grad = ts1.requires_grad or ts2.requires_grad
    dependency = []
    if ts1.requires_grad:
        dependency.append((ts1, grad_fn_ts1))
    if ts2.requires_grad:
        dependency.append((ts2, grad_fn_ts2))
    return ts1.__class__(values, requires_grad, dependency)


def build_unary_ops_tensor(ts, grad_fn, values):
    """reference contract: core/ops.py:23-29."""
    requires_grad = ts.requires_grad
    dependency = [(ts, grad_fn)] if requires_grad else []
    return ts.__class__(values, requires_grad, dependency)


def unbroadcast(grad, shape):
    """Reduce ``grad`` back to ``shape`` under numpy broadcasting rules.

    Sum over leading dims that were prepended by broadcasting, then
    keepdims-sum every axis where ``shape`` has size 1 but ``grad`` doesn't.
    One shared implementation for all binary VJPs (the reference inlines this
    per-op, reference: core/ops.py:39-55).
    """
    ndiff = grad.ndim - len(shape)
    if ndiff > 0:
        grad = grad.sum(axis=tuple(range(ndiff)))
    axes = tuple(
        i for i, dim in enumerate(shape) if dim == 1 and grad.shape[i] != 1
    )
    if axes:
        grad = grad.sum(axis=axes, keepdims=True)
    return grad


# --------------------------------------------------------------------------
# binary ops
# --------------------------------------------------------------------------

def add_(ts1, ts2):
    """c = a + b (reference: core/ops.py:32-58)."""
    values = ts1.data + ts2.data

    def grad_fn_ts1(grad):
        return unbroadcast(grad, ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(grad, ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def sub_(ts1, ts2):
    """c = a - b, composed as a + (-b) (reference: core/ops.py:61-62)."""
    return ts1 + (-ts2)


def mul_(ts1, ts2):
    """c = a * b (reference: core/ops.py:65-90)."""
    values = ts1.data * ts2.data

    def grad_fn_ts1(grad):
        return unbroadcast(grad * ts2.data, ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(grad * ts1.data, ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def div_(ts1, ts2):
    """c = a / b (reference: core/ops.py:93-118)."""
    values = ts1.data / ts2.data

    def grad_fn_ts1(grad):
        return unbroadcast(grad / ts2.data, ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(-grad * ts1.data / ts2.data ** 2, ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def pow_(ts1, ts2):
    """c = a ** b (reference: core/ops.py:121-147).

    d/da = b * a**(b-1); d/db = ln(a) * a**b (NaN for a <= 0, matching numpy).
    """
    a, b = ts1.data, ts2.data
    values = a ** b

    def grad_fn_ts1(grad):
        return unbroadcast(grad * b * a ** (b - 1), ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(grad * jnp.log(a) * values, ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def _swap_last2(x):
    return jnp.swapaxes(x, -1, -2)


def dot_(ts1, ts2):
    """c = a @ b with numpy.matmul semantics (reference: core/ops.py:150-162).

    Extends the reference (strictly 2-D) to 1-D operands and batched N-D
    matmul with broadcast batch dims, all through kernels.matmul.
    """
    a, b = ts1.data, ts2.data
    values = kernels.matmul(a, b)

    if a.ndim == 1 and b.ndim == 1:
        def grad_fn_ts1(grad):
            return grad * b

        def grad_fn_ts2(grad):
            return grad * a
    elif b.ndim == 1:
        # (..., m, k) @ (k,) -> (..., m)
        def grad_fn_ts1(grad):
            return unbroadcast(grad[..., None] * b, ts1.shape)

        def grad_fn_ts2(grad):
            g = grad[..., None, :] @ a  # (..., 1, k)
            return unbroadcast(g[..., 0, :], ts2.shape)
    elif a.ndim == 1:
        # (k,) @ (..., k, n) -> (..., n)
        def grad_fn_ts1(grad):
            g = b @ grad[..., None]  # (..., k, 1)
            return unbroadcast(g[..., 0], ts1.shape)

        def grad_fn_ts2(grad):
            return unbroadcast(a[:, None] * grad[..., None, :], ts2.shape)
    else:
        def grad_fn_ts1(grad):
            return unbroadcast(kernels.matmul(grad, _swap_last2(b)), ts1.shape)

        def grad_fn_ts2(grad):
            return unbroadcast(kernels.matmul(_swap_last2(a), grad), ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def maximum_(ts1, ts2):
    """Elementwise max; ties route the full gradient to the FIRST argument
    (reference: core/ops.py:165-187)."""
    a, b = ts1.data, ts2.data
    values = jnp.maximum(a, b)

    def grad_fn_ts1(grad):
        return unbroadcast(grad * (a >= b), ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(grad * (b > a), ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


def minimum_(ts1, ts2):
    """Elementwise min; ties go to the first argument
    (reference: core/ops.py:190-212)."""
    a, b = ts1.data, ts2.data
    values = jnp.minimum(a, b)

    def grad_fn_ts1(grad):
        return unbroadcast(grad * (a <= b), ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(grad * (b < a), ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)


# --------------------------------------------------------------------------
# unary ops
# --------------------------------------------------------------------------

def exp_(ts):
    """reference: core/ops.py:216-221."""
    values = jnp.exp(ts.data)

    def grad_fn(grad):
        return values * grad

    return build_unary_ops_tensor(ts, grad_fn, values)


def _normalize_axes(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (tuple, list)):
        return tuple(a % ndim for a in axis)
    return (axis % ndim,)


def _reduce_extreme(ts, axis, reducer):
    """Shared machinery for max_/min_ reductions.

    Tie semantics match the reference: every element equal to the extreme
    receives the FULL incoming gradient (no splitting) (reference:
    core/ops.py:225-240). Unlike the reference, works for any axis: the
    incoming gradient is re-expanded at the reduced axes before masking
    (fixes reference: core/ops.py:229 which breaks for non-leading axes).
    """
    x = ts.data
    axes = _normalize_axes(axis, x.ndim)
    values = reducer(x, axis=axis)
    kd = reducer(x, axis=axis, keepdims=True)
    mask = (x == kd)

    def grad_fn(grad):
        if axes is not None:
            grad = jnp.expand_dims(grad, axes)
        return grad * mask

    return build_unary_ops_tensor(ts, grad_fn, values)


def max_(ts, axis=None):
    return _reduce_extreme(ts, axis, jnp.max)


def min_(ts, axis=None):
    return _reduce_extreme(ts, axis, jnp.min)


def log_(ts):
    """reference: core/ops.py:243-248."""
    values = jnp.log(ts.data)

    def grad_fn(grad):
        return grad / ts.data

    return build_unary_ops_tensor(ts, grad_fn, values)


def sum_(ts, axis=None, keepdims=False):
    """Reduce-sum; grad broadcasts back over the reduced axes
    (reference: core/ops.py:251-264; extended with tuple axes + keepdims)."""
    shape = ts.shape
    axes = _normalize_axes(axis, ts.data.ndim)
    values = ts.data.sum(axis=axis, keepdims=keepdims)

    def grad_fn(grad):
        if axes is not None and not keepdims:
            grad = jnp.expand_dims(grad, axes)
        return jnp.broadcast_to(grad, shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def mean_(ts, axis=None, keepdims=False):
    """Reduce-mean = sum / count, fused as a single primitive."""
    shape = ts.shape
    axes = _normalize_axes(axis, ts.data.ndim)
    values = ts.data.mean(axis=axis, keepdims=keepdims)
    if axes is None:
        count = ts.data.size
    else:
        count = 1
        for a in axes:
            count *= shape[a]

    def grad_fn(grad):
        if axes is not None and not keepdims:
            grad = jnp.expand_dims(grad, axes)
        return jnp.broadcast_to(grad / count, shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def transpose_(ts, axes=None):
    """reference: core/ops.py:267-278.

    Axes are normalized to non-negative before inverting the permutation, so
    numpy-legal negative axes (e.g. (-1, 0, 1)) transpose the cotangent by
    the correct inverse instead of a garbage argsort order.
    """
    values = ts.data.transpose(axes)
    if axes is None:
        axes = list(reversed(range(ts.data.ndim)))
    ndim = ts.data.ndim
    axes = [a % ndim for a in axes]
    inv = np.argsort(axes)

    def grad_fn(grad):
        return grad.transpose(inv)

    return build_unary_ops_tensor(ts, grad_fn, values)


def _coerce_key(key):
    from tinynn_autograd_tpu.core.tensor import Tensor

    def one(k):
        return k.data if isinstance(k, Tensor) else k

    if isinstance(key, tuple):
        return tuple(one(k) for k in key)
    return one(key)


def getitem_(ts, key):
    """Indexing/slicing; VJP scatters the gradient back into a zero tensor.

    Divergence from the reference (core/ops.py:282-288): repeated indices
    ACCUMULATE via scatter-add — the calculus-correct adjoint — instead of the
    reference's last-write-wins assignment.
    """
    key = _coerce_key(key)
    values = ts.data[key]

    def grad_fn(grad):
        zeros = jnp.zeros(ts.shape, dtype=grad.dtype)
        return zeros.at[key].add(grad)

    return build_unary_ops_tensor(ts, grad_fn, values)


def neg_(ts):
    """reference: core/ops.py:292-297."""
    values = -ts.data

    def grad_fn(grad):
        return -grad

    return build_unary_ops_tensor(ts, grad_fn, values)


def reshape_(ts, newshape):
    """reference: core/ops.py:301-307."""
    shape = ts.shape
    values = ts.data.reshape(newshape)

    def grad_fn(grad):
        return grad.reshape(shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def pad_(ts, pad_width, mode="constant", constant_values=0):
    """Pad; gradient slices out the interior (reference: core/ops.py:311-320).

    The interior-slice adjoint is only correct for constant padding, so other
    modes refuse to build a tape edge instead of silently producing wrong
    gradients (the reference computes the same slice for every mode).
    ``constant_values`` supports e.g. -inf padding for pooling windows.
    """
    if mode == "constant":
        values = jnp.pad(ts.data, pad_width=pad_width, mode=mode,
                         constant_values=constant_values)
    else:
        values = jnp.pad(ts.data, pad_width=pad_width, mode=mode)
    if ts.requires_grad and mode != "constant":
        raise ValueError(
            "pad gradient is only defined for mode='constant', got %r" % mode
        )
    slices = tuple(
        slice(before, size - after)
        for size, (before, after) in zip(values.shape, pad_width)
    )

    def grad_fn(grad):
        return grad[slices]

    return build_unary_ops_tensor(ts, grad_fn, values)


def flatten_(ts):
    """reference: core/ops.py:323-330."""
    shape = ts.shape
    values = ts.data.reshape(-1)

    def grad_fn(grad):
        return grad.reshape(shape)

    return build_unary_ops_tensor(ts, grad_fn, values)


def clip_(ts, min=None, max=None):
    """Clip; boundary values are INCLUDED in the pass-through mask, so e.g.
    d/dx relu(0) = 1 (reference: core/ops.py:333-344)."""
    values = jnp.clip(ts.data, min, max)

    mask = jnp.ones(ts.shape, dtype=bool)
    if min is not None:
        mask = mask & (ts.data >= min)
    if max is not None:
        mask = mask & (ts.data <= max)

    def grad_fn(grad):
        return grad * mask

    return build_unary_ops_tensor(ts, grad_fn, values)


def astype_(ts, dtype):
    """Dtype cast; gradient casts back to the source gradient dtype."""
    src = ts.data.dtype
    values = ts.data.astype(dtype)

    def grad_fn(grad):
        if jnp.issubdtype(src, jnp.inexact):
            return grad.astype(src)
        return grad

    return build_unary_ops_tensor(ts, grad_fn, values)


# --------------------------------------------------------------------------
# fused activation / normalization primitives (additions)
# --------------------------------------------------------------------------

def sigmoid_(ts):
    """Numerically stable logistic; d/dx = y * (1 - y).

    (The reference Sigmoid calls np.exp on a Tensor and crashes,
    reference: core/layers.py:74-80 — implemented correctly here.)
    """
    values = jax.nn.sigmoid(ts.data)

    def grad_fn(grad):
        return grad * values * (1.0 - values)

    return build_unary_ops_tensor(ts, grad_fn, values)


def tanh_(ts):
    """True tanh; d/dx = 1 - y**2.

    (The reference Tanh computes tanh(x/2), reference: core/layers.py:83-89 —
    implemented correctly here.)
    """
    values = jnp.tanh(ts.data)

    def grad_fn(grad):
        return grad * (1.0 - values * values)

    return build_unary_ops_tensor(ts, grad_fn, values)


def relu_(ts):
    """max(x, 0); subgradient at 0 is 1 to match the reference's
    boundary-inclusive clip mask (reference: core/layers.py:92-98 via
    core/ops.py:333-344)."""
    x = ts.data
    values = jnp.maximum(x, 0)

    def grad_fn(grad):
        return grad * (x >= 0)

    return build_unary_ops_tensor(ts, grad_fn, values)


def leaky_relu_(ts, negative_slope=0.01):
    x = ts.data
    values = jnp.where(x >= 0, x, negative_slope * x)

    def grad_fn(grad):
        return grad * jnp.where(x >= 0, 1.0, negative_slope)

    return build_unary_ops_tensor(ts, grad_fn, values)


def softplus_(ts):
    """log(1 + exp(x)) computed stably; d/dx = sigmoid(x)."""
    x = ts.data
    values = jax.nn.softplus(x)

    def grad_fn(grad):
        return grad * jax.nn.sigmoid(x)

    return build_unary_ops_tensor(ts, grad_fn, values)


def silu_(ts):
    """SiLU / swish: x * sigmoid(x); d/dx = s * (1 + x * (1 - s)).

    The gate activation of SwiGLU MLPs (LlamaBlock). No reference
    counterpart (the reference's activation zoo is Sigmoid/Tanh/ReLU,
    core/layers.py:74-98)."""
    x = ts.data
    s = jax.nn.sigmoid(x)
    values = x * s

    def grad_fn(grad):
        return grad * s * (1.0 + x * (1.0 - s))

    return build_unary_ops_tensor(ts, grad_fn, values)


def gelu_(ts):
    """Tanh-approximation GELU with its exact hand derivative."""
    x = ts.data
    c = np.sqrt(2.0 / np.pi).astype(np.float32)
    inner = c * (x + 0.044715 * x ** 3)
    t = jnp.tanh(inner)
    values = 0.5 * x * (1.0 + t)

    def grad_fn(grad):
        dinner = c * (1.0 + 3 * 0.044715 * x ** 2)
        return grad * (0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * dinner)

    return build_unary_ops_tensor(ts, grad_fn, values)


def abs_(ts):
    x = ts.data
    values = jnp.abs(x)

    def grad_fn(grad):
        return grad * jnp.sign(x)

    return build_unary_ops_tensor(ts, grad_fn, values)


def sqrt_(ts):
    values = jnp.sqrt(ts.data)

    def grad_fn(grad):
        return grad * 0.5 / values

    return build_unary_ops_tensor(ts, grad_fn, values)


def log_softmax_(ts, axis=-1):
    """Row-stable log-softmax; VJP: g - exp(y) * sum(g, axis, keepdims).

    This is the kernel under SoftmaxCrossEntropyLoss — per-row max-shift and
    per-row normalizer (the reference uses a GLOBAL max and sum which is not a
    softmax, reference: core/losses.py:26-27; implemented correctly here).
    """
    x = ts.data
    values = jax.nn.log_softmax(x, axis=axis)

    def grad_fn(grad):
        return grad - jnp.exp(values) * grad.sum(axis=axis, keepdims=True)

    return build_unary_ops_tensor(ts, grad_fn, values)


def _hash_bits_u32(shape, seed):
    """Counter-based uint32 stream (murmur3-style finalizer over iota+seed):
    i.i.d.-looking bits from a traced integer seed, no PRNG key needed."""
    n = 1
    for s in shape:
        n *= int(s)
    x = jax.lax.iota(jnp.uint32, n)
    x = x + jnp.asarray(seed).astype(jnp.uint32) * jnp.uint32(2654435761)
    x = (x ^ (x >> 16)) * jnp.uint32(0x7FEB352D)
    x = (x ^ (x >> 15)) * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x.reshape(shape)


def _flat_iota_u32(shape):
    """Row-major flat element index as uint32, built from per-dim
    broadcasted_iota."""
    idx = None
    stride = 1
    for d in reversed(range(len(shape))):
        term = jax.lax.broadcasted_iota(jnp.uint32, shape, d) * jnp.uint32(
            stride)
        idx = term if idx is None else idx + term
        stride *= int(shape[d])
    return idx


def stochastic_round_cast(x, dtype, seed):
    """float32 -> bfloat16 with STOCHASTIC rounding: uniform random bits
    are added below the bf16 mantissa cutoff before truncation, so
    E[result] == x elementwise. This is what makes low-precision EMA
    state sound: round-to-nearest drops relative increments below bf16's
    2^-8 resolution (slow-moving Adam v stalls), while stochastic
    rounding preserves them in expectation.

    ``seed`` may be a traced int (e.g. the step counter) — the bits come
    from a counter-hash of the element index, so the cast runs the same
    eagerly and inside the jitted step. Not a tape primitive (no gradient
    flows through optimizer state)."""
    if jnp.dtype(dtype) != jnp.bfloat16:
        # only the bf16 mantissa cutoff is implemented; silently degrading
        # to round-to-nearest would ignore the caller's request
        raise NotImplementedError(
            "stochastic_round_cast supports bfloat16 targets only, got %s"
            % jnp.dtype(dtype))
    xf = x.astype(jnp.float32)
    if xf.ndim < 2:
        bits_r = _hash_bits_u32(xf.shape, seed)
    else:
        h = _flat_iota_u32(xf.shape)
        h = h + jnp.asarray(seed).astype(jnp.uint32) * jnp.uint32(2654435761)
        h = (h ^ (h >> 16)) * jnp.uint32(0x7FEB352D)
        h = (h ^ (h >> 15)) * jnp.uint32(0x846CA68B)
        bits_r = h ^ (h >> 16)
    bits = jax.lax.bitcast_convert_type(xf, jnp.uint32)
    bits = bits + (bits_r & jnp.uint32(0xFFFF))
    bits = bits & jnp.uint32(0xFFFF0000)
    return jax.lax.bitcast_convert_type(bits, jnp.float32).astype(dtype)


def layer_norm_(ts_x, ts_gamma, ts_beta, eps=1e-5):
    """Layer normalization over the LAST axis with learned scale/shift:
    y = (x - mean)/sqrt(var + eps) * gamma + beta.

    Hand VJPs (no jax.grad):
      dx    = (gamma*g - mean(gamma*g) - xhat * mean(gamma*g * xhat)) / std
      dgamma = sum over leading axes of g * xhat    (unbroadcast to shape)
      dbeta  = sum over leading axes of g
    One fused primitive instead of a mean/sub/sqrt/div composition keeps
    the tape short and lets XLA emit a single normalization kernel.
    (No reference counterpart — the reference has no normalization layers.)
    """
    x, gamma, beta = ts_x.data, ts_gamma.data, ts_beta.data
    mu = x.mean(axis=-1, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=-1, keepdims=True)
    std = jnp.sqrt(var + eps)
    xhat = (x - mu) / std
    values = xhat * gamma + beta

    def grad_fn_x(grad):
        gg = grad * gamma
        m1 = gg.mean(axis=-1, keepdims=True)
        m2 = (gg * xhat).mean(axis=-1, keepdims=True)
        return (gg - m1 - xhat * m2) / std

    def grad_fn_gamma(grad):
        return unbroadcast(grad * xhat, ts_gamma.shape)

    def grad_fn_beta(grad):
        return unbroadcast(grad, ts_beta.shape)

    requires_grad = (ts_x.requires_grad or ts_gamma.requires_grad
                     or ts_beta.requires_grad)
    dependency = []
    if ts_x.requires_grad:
        dependency.append((ts_x, grad_fn_x))
    if ts_gamma.requires_grad:
        dependency.append((ts_gamma, grad_fn_gamma))
    if ts_beta.requires_grad:
        dependency.append((ts_beta, grad_fn_beta))
    return ts_x.__class__(values, requires_grad, dependency)


def rms_norm_(ts_x, ts_gamma, eps=1e-6):
    """RMS normalization over the LAST axis with a learned scale (no
    centering, no shift — the llama-family norm): y = x * rsqrt(mean(x^2)
    + eps) * gamma.

    Hand VJP (no jax.grad). With r = rsqrt(mean(x^2) + eps) and
    xhat = x * r:
      dx     = (gamma*g - xhat * mean(gamma*g * xhat)) * r
      dgamma = sum over leading axes of g * xhat  (unbroadcast to shape)
    — the layer_norm_ rule without the mean-subtraction term. One fused
    primitive keeps the tape short; XLA emits a single normalization
    kernel. (No reference counterpart — the reference has no
    normalization layers.)"""
    x, gamma = ts_x.data, ts_gamma.data
    r = jax.lax.rsqrt((x * x).mean(axis=-1, keepdims=True) + eps)
    xhat = x * r
    values = xhat * gamma

    def grad_fn_x(grad):
        gg = grad * gamma
        m2 = (gg * xhat).mean(axis=-1, keepdims=True)
        return (gg - xhat * m2) * r

    def grad_fn_gamma(grad):
        return unbroadcast(grad * xhat, ts_gamma.shape)

    requires_grad = ts_x.requires_grad or ts_gamma.requires_grad
    dependency = []
    if ts_x.requires_grad:
        dependency.append((ts_x, grad_fn_x))
    if ts_gamma.requires_grad:
        dependency.append((ts_gamma, grad_fn_gamma))
    return ts_x.__class__(values, requires_grad, dependency)


def _rope_tables(t, half, base, positions, dtype):
    """cos/sin tables [T, half] for rotary embedding: angle(p, i) =
    p * base^(-i/half)."""
    if positions is None:
        positions = jnp.arange(t, dtype=jnp.float32)
    else:
        positions = jnp.asarray(positions).astype(jnp.float32)
    inv_freq = base ** (-jnp.arange(half, dtype=jnp.float32) / half)
    ang = positions[:, None] * inv_freq[None, :]
    return jnp.cos(ang).astype(dtype), jnp.sin(ang).astype(dtype)


def rope_(ts, base=10000.0, positions=None):
    """Rotary position embedding (RoPE) over the last axis, half-split
    (GPT-NeoX / llama) convention: x [..., T, d] with d even; lane i pairs
    with lane i + d/2 and the pair is rotated by angle
    pos * base^(-2i/d):
      y1 = x1*cos - x2*sin ;  y2 = x2*cos + x1*sin

    The half-split form keeps both halves CONTIGUOUS — no stride-2
    gathers, so XLA lowers it as two slices and fused elementwise math.

    ``positions``: optional int/float [T] position ids (defaults to
    arange(T)); serving passes the absolute offset of a decoded token.

    Hand VJP: per (position, pair) the map is an orthogonal 2-D rotation,
    so the backward rotates the cotangent by the NEGATED angle:
      g1' = g1*cos + g2*sin ;  g2' = g2*cos - g1*sin
    (No reference counterpart — the reference has no sequence models.)"""
    x = ts.data
    d = x.shape[-1]
    t = x.shape[-2]
    if d % 2:
        raise ValueError("rope_ needs an even last dim, got %d" % d)
    half = d // 2
    cos, sin = _rope_tables(t, half, float(base), positions, x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    values = jnp.concatenate(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1)

    def grad_fn(grad):
        g1, g2 = grad[..., :half], grad[..., half:]
        return jnp.concatenate(
            [g1 * cos + g2 * sin, g2 * cos - g1 * sin], axis=-1)

    return build_unary_ops_tensor(ts, grad_fn, values)


def batch_norm_(ts_x, ts_gamma, ts_beta, axes=(0,), eps=1e-5):
    """Batch normalization over ``axes`` (the batch/spatial axes) with
    learned per-feature scale/shift. Same hand-VJP structure as
    layer_norm_ with the statistics taken over ``axes``:
      dx = (gamma*g - mean_A(gamma*g) - xhat * mean_A(gamma*g*xhat)) / std
    Returns (out_tensor, batch_mean, batch_var) — the concrete batch stats
    let the BatchNorm layer maintain running estimates eagerly."""
    x, gamma, beta = ts_x.data, ts_gamma.data, ts_beta.data
    axes = tuple(axes)
    mu = x.mean(axis=axes, keepdims=True)
    var = ((x - mu) ** 2).mean(axis=axes, keepdims=True)
    std = jnp.sqrt(var + eps)
    xhat = (x - mu) / std
    values = xhat * gamma + beta

    def grad_fn_x(grad):
        gg = grad * gamma
        m1 = gg.mean(axis=axes, keepdims=True)
        m2 = (gg * xhat).mean(axis=axes, keepdims=True)
        return (gg - m1 - xhat * m2) / std

    def grad_fn_gamma(grad):
        return unbroadcast(grad * xhat, ts_gamma.shape)

    def grad_fn_beta(grad):
        return unbroadcast(grad, ts_beta.shape)

    requires_grad = (ts_x.requires_grad or ts_gamma.requires_grad
                     or ts_beta.requires_grad)
    dependency = []
    if ts_x.requires_grad:
        dependency.append((ts_x, grad_fn_x))
    if ts_gamma.requires_grad:
        dependency.append((ts_gamma, grad_fn_gamma))
    if ts_beta.requires_grad:
        dependency.append((ts_beta, grad_fn_beta))
    out = ts_x.__class__(values, requires_grad, dependency)
    return out, mu.squeeze(), var.squeeze()


def softmax_(ts, axis=-1):
    """Row-stable softmax; VJP: dx = y * (g - sum(g*y, axis, keepdims)).

    Fused primitive (one tape node) — the attention hot path. Same
    numerics as exp(log_softmax(x)).
    """
    values = jax.nn.softmax(ts.data, axis=axis)

    def grad_fn(grad):
        return values * (grad - (grad * values).sum(axis=axis,
                                                    keepdims=True))

    return build_unary_ops_tensor(ts, grad_fn, values)


def dropout_(ts, rate, rng):
    """Inverted dropout: zero with prob ``rate``, scale survivors by 1/(1-p).

    ``rng`` is a jax PRNG key (traced under jit, so each compiled step can
    fold in the step counter for fresh masks)."""
    keep = 1.0 - rate
    scale = 1.0 / keep
    mask = jax.random.bernoulli(rng, p=keep, shape=ts.shape)
    values = jnp.where(mask, ts.data * scale, 0.0)

    def grad_fn(grad):
        return jnp.where(mask, grad * scale, 0.0)

    return build_unary_ops_tensor(ts, grad_fn, values)


def flash_attention_(ts_q, ts_k, ts_v, causal=False, scale=None, impl=None,
                     dropout_rate=0.0, dropout_rng=None, window=None):
    """Fused multi-head attention as ONE tape primitive:
    out = softmax(Q K^T * scale [+ causal mask]) V, Q/K/V: [B, H, T, d].

    Forward and the hand-written VJPs run as flash-style Triton kernels on
    the GPU (online softmax, O(T) memory — see ops/attention.py) with an
    exact-math XLA twin elsewhere. The three grad_fns share one memoized
    joint backward (the recompute scheme needs Q, K, V, O and the saved
    row logsumexp once per cotangent). Replaces the 4-primitive tape chain
    (dot_/softmax_/dot_) in TransformerBlock — same numerics, no [T, T]
    score tensors in device memory. No jax.grad anywhere.

    ``dropout_rate`` > 0 applies attention-probability dropout INSIDE the
    kernels: keep decisions are a counter-hash of the absolute
    (head, query, key) index + a seed derived from ``dropout_rng`` (a jax
    PRNG key, traced ok), so the recompute backward replays the exact
    forward mask without any [T, T] mask tensor existing anywhere.

    GROUPED-QUERY ATTENTION (native): K/V may carry FEWER heads than Q
    (Hkv dividing H; query head j reads kv head j // (H/Hkv)). The
    kernels index the shared K/V head directly and the dK/dV kernel sums
    over its query group, so the repeated [B, H, T, d] K/V never
    materializes.

    ``window``: SLIDING-WINDOW attention (requires ``causal``) — position
    p attends only keys in (p - window, p]. The kernels' loops visit only
    the in-band tiles (O(T*window) cost); the XLA twin masks in place.
    The recompute backward applies the identical band.
    """
    from tinynn_autograd_tpu.ops import attention

    q, k, v = ts_q.data, ts_k.data, ts_v.data
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    seed = _attn_dropout_seed(dropout_rate, dropout_rng)
    o, lse = attention.mha_fwd(q, k, v, causal=causal, scale=scale,
                               impl=impl, dropout_rate=dropout_rate,
                               dropout_seed=seed, window=window)

    cache = []  # [grad_object, (dq, dk, dv)] — strong ref + identity compare

    def memo(grad):
        if not cache or cache[0] is not grad:
            cache[:] = [grad, attention.mha_bwd(
                q, k, v, o, lse, grad, causal=causal, scale=scale,
                impl=impl, dropout_rate=dropout_rate, dropout_seed=seed,
                window=window)]
        return cache[1]

    def gq(grad):
        return memo(grad)[0]

    def gk(grad):
        return memo(grad)[1]

    def gv(grad):
        return memo(grad)[2]

    requires_grad = (ts_q.requires_grad or ts_k.requires_grad
                     or ts_v.requires_grad)
    dependency = []
    if ts_q.requires_grad:
        dependency.append((ts_q, gq))
    if ts_k.requires_grad:
        dependency.append((ts_k, gk))
    if ts_v.requires_grad:
        dependency.append((ts_v, gv))
    return ts_q.__class__(o, requires_grad, dependency)


def _attn_dropout_seed(dropout_rate, dropout_rng):
    """uint32 kernel seed from a jax key; None when dropout is off."""
    if dropout_rate <= 0.0:
        return None
    if dropout_rng is None:
        from tinynn_autograd_tpu.utils import seeder

        dropout_rng = seeder.next_key()
    return jax.random.bits(dropout_rng, dtype=jnp.uint32)


def concat_(tensors, axis=0):
    """Concatenate along ``axis``; VJP slices the gradient back per input."""
    tensors = [as_tensor(t) for t in tensors]
    datas = [t.data for t in tensors]
    values = jnp.concatenate(datas, axis=axis)
    ax = axis % values.ndim

    requires_grad = builtins.any(t.requires_grad for t in tensors)
    dependency = []
    offset = 0
    for t in tensors:
        size = t.shape[ax]
        if t.requires_grad:
            def make_fn(start, length):
                def grad_fn(grad):
                    idx = [slice(None)] * grad.ndim
                    idx[ax] = slice(start, start + length)
                    return grad[tuple(idx)]

                return grad_fn

            dependency.append((t, make_fn(offset, size)))
        offset += size
    return tensors[0].__class__(values, requires_grad, dependency)


def conv2d_(ts_x, ts_w, stride, padding):
    """2-D convolution primitive, NHWC x HWIO -> NHWC.

    Forward and BOTH hand-written VJPs are single ``lax.conv_general_dilated``
    calls, each handed to the backend's convolution library by XLA:

    - dX: transposed conv — grad (lhs-dilated by the stride) convolved with
      the spatially-flipped, io-swapped kernel.
    - dW: batch-contraction conv — input (channels as batch) convolved with
      the grad (stride becomes rhs dilation).

    ``stride``: (sh, sw); ``padding``: ((plo_h, phi_h), (plo_w, phi_w)).
    No jax.grad anywhere — this is our tape's edge, like every primitive.
    """
    sh, sw = stride
    (plh, phh), (plw, phw) = padding
    x, w = ts_x.data, ts_w.data
    n, h, wd, c_in = x.shape
    kh, kw, _, c_out = w.shape
    dn = ("NHWC", "HWIO", "NHWC")

    values = jax.lax.conv_general_dilated(
        x, w, window_strides=(sh, sw), padding=[(plh, phh), (plw, phw)],
        dimension_numbers=dn, preferred_element_type=jnp.float32,
    ).astype(x.dtype)

    def grad_fn_x(grad):
        # output size remainder: rows/cols of x never touched by any window
        rh = (h + plh + phh - kh) % sh
        rw = (wd + plw + phw - kw) % sw
        w_flip = jnp.flip(w, (0, 1)).swapaxes(2, 3)  # (KH, KW, Co, Ci)
        return jax.lax.conv_general_dilated(
            grad, w_flip, window_strides=(1, 1),
            padding=[(kh - 1 - plh, kh - 1 - phh + rh),
                     (kw - 1 - plw, kw - 1 - phw + rw)],
            lhs_dilation=(sh, sw), dimension_numbers=dn,
            preferred_element_type=jnp.float32,
        ).astype(x.dtype)

    def grad_fn_w(grad):
        # crop the stride remainder off the high side so the result is
        # exactly (KH, KW): rows past the last window never contribute
        rh = (h + plh + phh - kh) % sh
        rw = (wd + plw + phw - kw) % sw
        lhs = x.transpose(3, 1, 2, 0)        # (Ci, H, W, N)
        rhs = grad.transpose(1, 2, 0, 3)     # (OH, OW, N, Co)
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(1, 1),
            padding=[(plh, phh - rh), (plw, phw - rw)],
            rhs_dilation=(sh, sw), dimension_numbers=dn,
            preferred_element_type=jnp.float32,
        )                                     # (Ci, KH, KW, Co)
        return out.transpose(1, 2, 0, 3).astype(w.dtype)

    return build_binary_ops_tensor(ts_x, ts_w, grad_fn_x, grad_fn_w, values)


def maxpool2d_(ts, pool, stride):
    """2-D max pooling over NHWC as a tree of maxima over the KH*KW strided
    window slices — no [N,OH,OW,KH*KW,C] patch stack is materialized.

    Tie semantics match the framework's reduce-max (and the reference's,
    reference: core/ops.py:225-230): EVERY element equal to the window max
    receives the full incoming gradient — the VJP masks each window slice
    against the pooled output independently and scatter-adds.
    """
    kh, kw = pool
    sh, sw = stride
    x = ts.data
    n, h, w, c = x.shape
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1

    def window(i, j):
        return x[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw, :]

    # forward: one fused windowed-reduce kernel (identical to the max-tree
    # over the window slices, which the VJP masks against)
    values = jax.lax.reduce_window(
        x, -jnp.inf if jnp.issubdtype(x.dtype, jnp.floating)
        else jnp.iinfo(x.dtype).min,
        jax.lax.max, (1, kh, kw, 1), (1, sh, sw, 1), "VALID")

    def grad_fn(grad):
        masked = [[grad * (window(i, j) == values) for j in range(kw)]
                  for i in range(kh)]
        if kh == sh and kw == sw:
            # classic non-overlapping pooling: every input cell belongs to
            # exactly one window position, so the cotangent is a pure
            # interleave — two stacks + one reshape instead of KH*KW
            # strided scatter-adds
            rows = [jnp.stack(r, axis=3) for r in masked]  # [N,OH,OW,kw,C]
            g = jnp.stack(rows, axis=2)                    # [N,OH,kh,OW,kw,C]
            g = g.reshape(n, oh * kh, ow * kw, c)
            if oh * kh != h or ow * kw != w:  # pool-dropped remainder rows
                g = jnp.pad(g, ((0, 0), (0, h - oh * kh),
                                (0, w - ow * kw), (0, 0)))
            return g
        dx = jnp.zeros_like(x)
        for i in range(kh):
            for j in range(kw):
                dx = dx.at[:, i:i + sh * (oh - 1) + 1:sh,
                           j:j + sw * (ow - 1) + 1:sw, :].add(masked[i][j])
        return dx

    return build_unary_ops_tensor(ts, grad_fn, values)


_STACK_ACTS = {
    "relu": (lambda z: jnp.maximum(z, 0.0), lambda z, a: (z >= 0.0)),
    "tanh": (jnp.tanh, lambda z, a: 1.0 - a * a),
    "sigmoid": (jax.nn.sigmoid, lambda z, a: a * (1.0 - a)),
    "linear": (lambda z: z, lambda z, a: jnp.ones_like(z)),
}


def dense_stack_(ts_x, ts_w, ts_b, activation="relu"):
    """L homogeneous Dense+activation layers as ONE primitive:
    h_{l+1} = act(h_l @ w[l] + b[l]), weights stacked w:[L,W,W], b:[L,1,W].

    Forward is a single ``lax.scan`` over the layer axis (one compiled
    layer-step kernel executed L times on-device) and the hand-written VJP
    is the mirrored REVERSE scan producing stacked dW/db and the input
    cotangent — so a 100-layer body costs two scan kernels per training
    step instead of ~300 individual op kernels. No jax.grad anywhere; this
    is a tape edge like every other primitive.
    """
    act_fn, act_grad = _STACK_ACTS[activation]
    x, w, b = ts_x.data, ts_w.data, ts_b.data

    def fwd_body(h, wb):
        wl, bl = wb
        z = kernels.matmul(h, wl) + bl
        a = act_fn(z)
        return a, (h, z, a)

    out, (h_ins, zs, acts) = jax.lax.scan(fwd_body, x, (w, b))

    # one shared backward computation per backward pass: memoize on the
    # incoming cotangent so the three grad_fns don't recompute the reverse
    # scan (XLA would CSE it anyway; this keeps the trace small). The cache
    # holds a STRONG reference to the cotangent and compares with `is`, so a
    # freed object whose id is reused can never alias a stale entry.
    cache = []  # [grad_object, (dx, dw, db)]

    def memo(grad):
        if not cache or cache[0] is not grad:
            cache[:] = [grad,
                        _dense_stack_bwd(grad, w, h_ins, zs, acts, act_grad)]
        return cache[1]

    def gx(grad):
        return memo(grad)[0]

    def gw(grad):
        return memo(grad)[1]

    def gb(grad):
        return memo(grad)[2]

    requires_grad = (ts_x.requires_grad or ts_w.requires_grad
                     or ts_b.requires_grad)
    dependency = []
    if ts_x.requires_grad:
        dependency.append((ts_x, gx))
    if ts_w.requires_grad:
        dependency.append((ts_w, gw))
    if ts_b.requires_grad:
        dependency.append((ts_b, gb))
    return ts_x.__class__(out, requires_grad, dependency)


def _dense_stack_bwd(grad, w, h_ins, zs, acts, act_grad):
    """Reverse scan over layers: dz = dh * act'(z); dW = h_in^T dz;
    db = sum_rows dz; dh = dz @ w^T."""

    def bwd_body(dh, layer):
        wl, h_in, z, a = layer
        dz = dh * act_grad(z, a)
        dwl = kernels.matmul(h_in.T, dz)
        dbl = dz.sum(axis=0, keepdims=True)
        dh_prev = kernels.matmul(dz, wl.T)
        return dh_prev, (dwl, dbl)

    dx, (dw, db) = jax.lax.scan(
        bwd_body, grad, (w, h_ins, zs, acts), reverse=True)
    return dx, dw, db


def pipeline_scan_(ts_h0, ts_w, ts_b, axis_name, n_stages, microbatches,
                   activation="relu"):
    """The GPipe tick loop as ONE tape primitive (SPMD, inside shard_map).

    Forward: ``lax.scan`` over the T = M+S-1 ticks — compile time is
    independent of the microbatch count M (the round-1 version Python-
    unrolled the ticks into the trace). Per tick, each device runs ONLY its
    own k-layer stage slice (w:[k,W,W], b:[k,1,W] local) on its current
    activation and hands the result to the next stage over ``ppermute``;
    the first stage reads microbatch ``t`` from ``h0`` ([M, mb, W],
    replicated) instead of the ring. Per-tick FLOPs = one stage's work —
    no proj/head/loss compute in the loop at all (callers batch those
    outside, see parallel/pipeline_parallel.py).

    Returns out [M, mb, W]: the last stage's outputs in microbatch order
    (garbage on other devices — callers mask by ``idx == S-1``).

    Backward is the hand-written reverse scan: cotangents re-cross the same
    ppermute links in the inverse direction with the same tick alignment,
    so the backward pipeline falls out of this single VJP — no separate
    backward schedule exists anywhere. Bubble slots carry exact zeros in
    both directions (forward consumes zero-init carries; backward's direct
    cotangent rows are zero-padded), so no gradient flows through them.
    No jax.grad anywhere; this is a tape edge like every other primitive.
    """
    act_fn, act_grad = _STACK_ACTS[activation]
    h0, w, b = ts_h0.data, ts_w.data, ts_b.data
    S, M = int(n_stages), int(microbatches)
    T = M + S - 1
    ring = [(i, (i + 1) % S) for i in range(S)]
    inv_ring = [(d, s) for (s, d) in ring]
    idx = jax.lax.axis_index(axis_name)
    is_first = (idx == 0)
    mb, width = h0.shape[1], h0.shape[2]

    def fwd_body(h_carry, t):
        # first stage consumes proj output t; others consume the ring carry
        x_in = jnp.where(is_first, h0[jnp.clip(t, 0, M - 1)], h_carry)

        def layer(h, wb):
            wl, bl = wb
            z = kernels.matmul(h, wl) + bl
            a = act_fn(z)
            return a, (h, z, a)

        h_out, saved = jax.lax.scan(layer, x_in, (w, b))
        h_next = jax.lax.ppermute(h_out, axis_name, ring)
        return h_next, (h_out, saved)

    _, (h_outs, saved) = jax.lax.scan(
        fwd_body, jnp.zeros((mb, width), h0.dtype), jnp.arange(T))
    out = h_outs[S - 1:]
    h_ins, zs, acts = saved  # each [T, k, mb, width]

    # same single-backward memo discipline as dense_stack_: strong ref +
    # identity compare, recompute on a fresh cotangent object
    cache = []

    def bwd(grad):
        # direct cotangent per tick: out row m was emitted at tick m+S-1
        d_direct = jnp.concatenate(
            [jnp.zeros((S - 1, mb, width), grad.dtype), grad], axis=0)

        def bwd_body(dh_carry, tick):
            d_out_t, h_ins_t, zs_t, acts_t = tick
            # adjoint of h_next = ppermute(h_out): the next tick's carry
            # cotangent crosses the same link in reverse
            dh_out = jax.lax.ppermute(
                dh_carry, axis_name, inv_ring) + d_out_t

            def layer_bwd(dh, layer):
                wl, h_in, z, a = layer
                dz = dh * act_grad(z, a)
                dwl = kernels.matmul(h_in.T, dz)
                dbl = dz.sum(axis=0, keepdims=True)
                dh_prev = kernels.matmul(dz, wl.T)
                return dh_prev, (dwl, dbl)

            dx_in, (dw_t, db_t) = jax.lax.scan(
                layer_bwd, dh_out, (w, h_ins_t, zs_t, acts_t), reverse=True)
            # adjoint of the x_in select: first stage's input came from h0,
            # everyone else's from the carry
            d_h0_row = jnp.where(is_first, dx_in, jnp.zeros_like(dx_in))
            dh_carry_prev = jnp.where(is_first, jnp.zeros_like(dx_in), dx_in)
            return dh_carry_prev, (d_h0_row, dw_t, db_t)

        _, (d_h0_rows, dw_ts, db_ts) = jax.lax.scan(
            bwd_body, jnp.zeros((mb, width), grad.dtype),
            (d_direct, h_ins, zs, acts), reverse=True)
        # ticks 0..M-1 map 1:1 onto h0 rows; ticks >= M are first-stage
        # bubbles whose cotangent is exactly zero (alignment above)
        return d_h0_rows[:M], dw_ts.sum(axis=0), db_ts.sum(axis=0)

    def memo(grad):
        if not cache or cache[0] is not grad:
            cache[:] = [grad, bwd(grad)]
        return cache[1]

    def gh0(grad):
        return memo(grad)[0]

    def gw(grad):
        return memo(grad)[1]

    def gb(grad):
        return memo(grad)[2]

    requires_grad = (ts_h0.requires_grad or ts_w.requires_grad
                     or ts_b.requires_grad)
    dependency = []
    if ts_h0.requires_grad:
        dependency.append((ts_h0, gh0))
    if ts_w.requires_grad:
        dependency.append((ts_w, gw))
    if ts_b.requires_grad:
        dependency.append((ts_b, gb))
    return ts_h0.__class__(out, requires_grad, dependency)


# --------------------------------------------------------------------------
# collective primitives (valid inside shard_map regions)
# --------------------------------------------------------------------------

def psum_(ts, axis_name):
    """All-reduce sum over a mesh axis, as a tape primitive.

    VJP is identity per shard: the cotangent of an all-reduced (replicated)
    value is already the total gradient each shard needs. Used by the
    tensor/pipeline-parallel layers so the same tape autodiff runs through
    collectives."""
    values = jax.lax.psum(ts.data, axis_name=axis_name)

    def grad_fn(grad):
        return grad

    return build_unary_ops_tensor(ts, grad_fn, values)


def all_gather_(ts, axis_name, axis=0):
    """Tiled all-gather over a mesh axis as a tape primitive: local chunks
    (size c on array axis ``axis``) concatenate in axis-index order to a
    replicated S*c extent.

    VJP is the dual collective, reduce-scatter: every device's cotangent
    chunk s belongs to device s, so each device receives the psum of its own
    chunk — ``lax.psum_scatter``. (With per-device DIFFERENT downstream
    compute — e.g. microbatch- or sequence-sharded segments — this is the
    mathematically correct adjoint; an identity VJP would drop other
    devices' cotangents.)
    """
    values = jax.lax.all_gather(ts.data, axis_name=axis_name, axis=axis,
                                tiled=True)

    def grad_fn(grad):
        return jax.lax.psum_scatter(grad, axis_name=axis_name,
                                    scatter_dimension=axis, tiled=True)

    return build_unary_ops_tensor(ts, grad_fn, values)


def psum_scatter_(ts, axis_name, axis=0):
    """Tiled reduce-scatter over a mesh axis as a tape primitive: inputs
    are summed elementwise across devices and device s keeps chunk s along
    array axis ``axis``.

    VJP is the dual collective, all-gather: input chunk s (on every device)
    contributed only to device s's output, so its cotangent is device s's —
    gathered back into the full-length layout."""
    values = jax.lax.psum_scatter(ts.data, axis_name=axis_name,
                                  scatter_dimension=axis, tiled=True)

    def grad_fn(grad):
        return jax.lax.all_gather(grad, axis_name=axis_name, axis=axis,
                                  tiled=True)

    return build_unary_ops_tensor(ts, grad_fn, values)


def all_to_all_(ts, axis_name, split_axis, concat_axis):
    """All-to-all over a mesh axis as a tape primitive: re-shards the array
    from ``concat_axis`` to ``split_axis`` (each device sends its
    split_axis chunks and concatenates what it receives on concat_axis) —
    the Ulysses attention transition (seq-sharded <-> head-sharded).

    all_to_all is a data permutation across the mesh, so its VJP is the
    INVERSE permutation: the same collective with the two axes swapped."""
    values = jax.lax.all_to_all(ts.data, axis_name, split_axis=split_axis,
                                concat_axis=concat_axis, tiled=True)

    def grad_fn(grad):
        return jax.lax.all_to_all(grad, axis_name, split_axis=concat_axis,
                                  concat_axis=split_axis, tiled=True)

    return build_unary_ops_tensor(ts, grad_fn, values)


def split_axis_(ts, axis_name, n_devices, axis=0):
    """Sequence-parallel entry transition: slice a REPLICATED tensor into
    per-device chunks along array axis ``axis`` (device s keeps chunk s).

    VJP all-gathers the per-device chunk cotangents back into the full
    replicated layout — each chunk's gradient lives on exactly one device,
    so the gather (not a psum) is the exact adjoint."""
    x = ts.data
    c = x.shape[axis] // n_devices
    idx = jax.lax.axis_index(axis_name)
    values = jax.lax.dynamic_slice_in_dim(x, idx * c, c, axis)

    def grad_fn(grad):
        return jax.lax.all_gather(grad, axis_name=axis_name, axis=axis,
                                  tiled=True)

    return build_unary_ops_tensor(ts, grad_fn, values)


def gather_axis_(ts, axis_name, n_devices, axis=0):
    """Sequence-parallel EXIT transition: all-gather per-device chunks into
    the replicated layout — the inverse of ``split_axis_``.

    VJP slices the device's own chunk back out. This differs from
    ``all_gather_`` (whose VJP is a reduce-scatter) on purpose: downstream
    of THIS gather every device redundantly computes the same replicated
    values, so the cotangent is already replicated and each chunk's
    gradient is read off directly — a psum there would n-fold overcount.
    Use ``all_gather_`` when downstream compute differs per device (sharded
    branches), ``gather_axis_`` when it is replicated."""
    values = jax.lax.all_gather(ts.data, axis_name=axis_name, axis=axis,
                                tiled=True)
    c = ts.shape[axis]

    def grad_fn(grad):
        idx = jax.lax.axis_index(axis_name)
        return jax.lax.dynamic_slice_in_dim(grad, idx * c, c, axis)

    return build_unary_ops_tensor(ts, grad_fn, values)


def replicate_grad_(ts, axis_name):
    """Megatron's "f" conjugate operator: IDENTITY forward on a replicated
    value whose VJP all-reduces the cotangent over the mesh axis.

    Needed wherever a replicated activation fans out into per-device
    SHARDED branches (e.g. the input of a column-parallel layer, or of a
    head-sharded attention block): each device's tape produces only its
    shard's partial contribution to the input cotangent, and the psum
    reassembles the true total before it flows further upstream. Without
    it, stacked Megatron pairs silently train on partial gradients."""
    values = ts.data

    def grad_fn(grad):
        return jax.lax.psum(grad, axis_name=axis_name)

    return build_unary_ops_tensor(ts, grad_fn, values)


def ppermute_(ts, axis_name, perm):
    """Point-to-point mesh permutation (lax.ppermute) as a tape primitive.

    VJP permutes the cotangent along the INVERSE permutation — gradients
    flow backward across the same links, which is exactly what routes the
    backward pass of a pipeline stage to its predecessor."""
    perm = list(perm)
    values = jax.lax.ppermute(ts.data, axis_name=axis_name, perm=perm)
    inv = [(dst, src) for (src, dst) in perm]

    def grad_fn(grad):
        return jax.lax.ppermute(grad, axis_name=axis_name, perm=inv)

    return build_unary_ops_tensor(ts, grad_fn, values)


def where_(cond, ts1, ts2):
    """Elementwise select; gradient flows to the selected branch only."""
    ts1, ts2 = as_tensor(ts1), as_tensor(ts2)
    from tinynn_autograd_tpu.core.tensor import Tensor

    c = cond.data if isinstance(cond, Tensor) else jnp.asarray(cond)
    values = jnp.where(c, ts1.data, ts2.data)

    def grad_fn_ts1(grad):
        return unbroadcast(jnp.where(c, grad, 0.0), ts1.shape)

    def grad_fn_ts2(grad):
        return unbroadcast(jnp.where(c, 0.0, grad), ts2.shape)

    return build_binary_ops_tensor(ts1, ts2, grad_fn_ts1, grad_fn_ts2, values)
