"""Functional op namespace mirroring the reference's ``core/ops.py`` surface
(coercing wrappers, reference: core/ops.py:347-384) plus the additions."""

from tinynn_autograd_tpu.ops import kernels
from tinynn_autograd_tpu.ops.primitives import (
    abs_,
    add_,
    all_gather_,
    all_to_all_,
    astype_,
    batch_norm_,
    build_binary_ops_tensor,
    build_unary_ops_tensor,
    clip_,
    concat_,
    conv2d_,
    dense_stack_,
    div_,
    dot_,
    dropout_,
    exp_,
    flash_attention_,
    flatten_,
    gather_axis_,
    gelu_,
    getitem_,
    layer_norm_,
    leaky_relu_,
    log_,
    log_softmax_,
    max_,
    maximum_,
    maxpool2d_,
    mean_,
    min_,
    minimum_,
    mul_,
    neg_,
    pad_,
    pipeline_scan_,
    pow_,
    ppermute_,
    psum_,
    psum_scatter_,
    relu_,
    replicate_grad_,
    reshape_,
    rms_norm_,
    rope_,
    sigmoid_,
    silu_,
    softmax_,
    split_axis_,
    softplus_,
    sqrt_,
    sub_,
    sum_,
    tanh_,
    transpose_,
    unbroadcast,
    where_,
)
from tinynn_autograd_tpu.ops.recurrent import gru_scan_, lstm_scan_
from tinynn_autograd_tpu.ops.remat import remat_
from tinynn_autograd_tpu.ops.ring_attention import ring_flash_attention_


def _as_tensor(obj):
    from tinynn_autograd_tpu.core.tensor import as_tensor

    return as_tensor(obj)


def max(obj, axis=None):  # noqa: A001 - parity with reference namespace
    return max_(_as_tensor(obj), axis=axis)


def min(obj, axis=None):  # noqa: A001
    return min_(_as_tensor(obj), axis=axis)


def maximum(obj1, obj2):
    return maximum_(_as_tensor(obj1), _as_tensor(obj2))


def minimum(obj1, obj2):
    return minimum_(_as_tensor(obj1), _as_tensor(obj2))


def exp(obj):
    return exp_(_as_tensor(obj))


def sum(obj, axis=None, keepdims=False):  # noqa: A001
    return sum_(_as_tensor(obj), axis=axis, keepdims=keepdims)


def mean(obj, axis=None, keepdims=False):
    return mean_(_as_tensor(obj), axis=axis, keepdims=keepdims)


def log(obj):
    return log_(_as_tensor(obj))


def reshape(obj, newshape):
    return reshape_(_as_tensor(obj), newshape)


def pad(obj, pad_width, mode="constant", constant_values=0):
    return pad_(_as_tensor(obj), pad_width, mode=mode,
                constant_values=constant_values)


def flatten(obj):
    return flatten_(_as_tensor(obj))


def clip(obj, min=None, max=None):  # noqa: A002
    return clip_(_as_tensor(obj), min, max)


def matmul(obj1, obj2):
    return dot_(_as_tensor(obj1), _as_tensor(obj2))


def transpose(obj, axes=None):
    return transpose_(_as_tensor(obj), axes=axes)


def sigmoid(obj):
    return sigmoid_(_as_tensor(obj))


def tanh(obj):
    return tanh_(_as_tensor(obj))


def relu(obj):
    return relu_(_as_tensor(obj))


def leaky_relu(obj, negative_slope=0.01):
    return leaky_relu_(_as_tensor(obj), negative_slope=negative_slope)


def softplus(obj):
    return softplus_(_as_tensor(obj))


def gelu(obj):
    return gelu_(_as_tensor(obj))


def silu(obj):
    return silu_(_as_tensor(obj))


def abs(obj):  # noqa: A001
    return abs_(_as_tensor(obj))


def sqrt(obj):
    return sqrt_(_as_tensor(obj))


def log_softmax(obj, axis=-1):
    return log_softmax_(_as_tensor(obj), axis=axis)


def dropout(obj, rate, rng):
    return dropout_(_as_tensor(obj), rate, rng)


def concat(tensors, axis=0):
    return concat_(tensors, axis=axis)


def where(cond, a, b):
    return where_(cond, a, b)
