"""Loss functions (reference surface: core/losses.py).

SoftmaxCrossEntropyLoss is the standard numerically-stable PER-ROW softmax
cross-entropy — a deliberate fix of the reference, whose "softmax" subtracts
the GLOBAL max and divides by the GLOBAL sum over the whole batch
(reference: core/losses.py:26-27; SURVEY.md §2 verifies loss 1.018 vs 0.314
standard on a 2x3 case). The stable log-softmax runs as one fused primitive
(ops.log_softmax_) so the forward+VJP stay a single VPU-friendly kernel
under XLA fusion.

Extras beyond the reference: MSELoss, MAELoss, HuberLoss,
SigmoidCrossEntropyLoss.
"""

import jax.numpy as jnp

import tinynn_autograd_tpu.ops as ops
from tinynn_autograd_tpu.core.tensor import as_tensor


def _f32_logits(logits):
    """Upcast sub-32-bit logits (bf16 mixed-precision nets) to f32 before
    the log-softmax/softplus reductions — the standard mixed-precision
    policy keeps the loss in f32; the astype_ VJP returns the cotangent in
    the net's compute dtype. f32/f64 logits pass through untouched."""
    if (jnp.issubdtype(logits.dtype, jnp.inexact)
            and jnp.finfo(logits.dtype).bits < 32):
        return ops.astype_(logits, jnp.float32)
    return logits


class BaseLoss:

    def loss(self, predicted, actual):
        raise NotImplementedError

    def __call__(self, predicted, actual):
        return self.loss(predicted, actual)


class SoftmaxCrossEntropyLoss(BaseLoss):
    """L = mean_i  w_i * (-sum_c labels[i,c] * log_softmax(logits)[i,c])

    ``labels`` is one-hot [m, C]. ``weight`` is an optional per-class [C]
    vector; each sample's NLL is scaled by the weight of its true class
    (the reference's weight path indexes an ndarray with a Tensor and
    raises, reference: core/losses.py:30-31 — implemented working here).
    The denominator is m (sample count), matching the reference's
    ``nll.sum() / m`` (reference: core/losses.py:32).
    """

    def __init__(self, weight=None):
        self._weight = jnp.asarray(weight) if weight is not None else None

    def loss(self, logits, labels):
        logits, labels = as_tensor(logits), as_tensor(labels)
        logits = _f32_logits(logits)
        m = logits.shape[0]
        log_p = ops.log_softmax_(logits, axis=-1)
        # keepdims: all intermediates keep the logits' rank
        nll = -(log_p * labels).sum(axis=1, keepdims=True)
        if self._weight is not None:
            per_sample_w = (labels * self._weight).sum(axis=1, keepdims=True)
            nll = nll * per_sample_w
        return nll.sum() / m


class SigmoidCrossEntropyLoss(BaseLoss):
    """Binary CE on logits, computed stably:
    L = mean( max(x, 0) - x*y + softplus(-|x|) )."""

    def loss(self, logits, labels):
        logits, labels = as_tensor(logits), as_tensor(labels)
        logits = _f32_logits(logits)
        m = logits.shape[0]
        relu_x = ops.relu(logits)
        per = relu_x - logits * labels + ops.softplus(-ops.abs(logits))
        return per.sum() / m


class MSELoss(BaseLoss):
    """mean over batch of sum-squared-error per sample."""

    def loss(self, predicted, actual):
        predicted, actual = as_tensor(predicted), as_tensor(actual)
        m = predicted.shape[0]
        return ((predicted - actual) ** 2).sum() / m


class MAELoss(BaseLoss):

    def loss(self, predicted, actual):
        predicted, actual = as_tensor(predicted), as_tensor(actual)
        m = predicted.shape[0]
        return ops.abs(predicted - actual).sum() / m


class HuberLoss(BaseLoss):
    """Quadratic within ±delta, linear outside."""

    def __init__(self, delta=1.0):
        self._delta = delta

    def loss(self, predicted, actual):
        predicted, actual = as_tensor(predicted), as_tensor(actual)
        m = predicted.shape[0]
        err = predicted - actual
        abs_err = ops.abs(err)
        quad = 0.5 * err ** 2
        lin = self._delta * abs_err - 0.5 * self._delta ** 2
        per = ops.where(abs_err <= self._delta, quad, lin)
        return per.sum() / m
