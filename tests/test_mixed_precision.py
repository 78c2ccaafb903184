"""bf16 mixed-precision training (compute_dtype= on the matmul layers).

Policy under test (the standard jmp/flax discipline: bf16 is the tensor
cores' fast input dtype and halves activation memory traffic):
- params, their gradients, and optimizer state stay f32 MASTER copies —
  the cast happens at the use site and astype_'s VJP casts the weight
  cotangent back to f32 (nn/layers.py _to_dtype);
- matmuls, the residual stream, and inter-layer activations run in
  compute_dtype;
- norms (LayerNorm/RMSNorm), the attention core (softmax), and the loss
  run in f32 (losses._f32_logits upcasts sub-32-bit logits);
- the scanned epoch traces the same casts as the single fused step.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import tinynn_autograd_tpu.ops as ops
from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.models import (
    build_mnist_mlp, build_tiny_llama, build_tiny_transformer,
)
from tinynn_autograd_tpu.nn.layers import (
    Conv2D, Dense, LlamaBlock, ReLU, TransformerBlock,
)
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.net import Net
from tinynn_autograd_tpu.nn.optimizer import Adam, SGD
from tinynn_autograd_tpu.utils import seeder

BF16 = jnp.bfloat16


def _grads_close(g_lo, g_hi, rtol=0.05, atol=0.05):
    """bf16 has ~3 decimal digits; compare against the f32 twin loosely,
    normalizing by the f32 grad scale."""
    scale = max(1e-6, float(np.max(np.abs(g_hi))))
    np.testing.assert_allclose(np.asarray(g_lo, np.float32) / scale,
                               np.asarray(g_hi, np.float32) / scale,
                               rtol=rtol, atol=atol)


def test_dense_bf16_forward_dtype_and_f32_master_grads():
    seeder.random_seed(0)
    lo = Dense(8, num_in=16, seed=7, compute_dtype=BF16)
    hi = Dense(8, num_in=16, seed=7)
    x = np.random.RandomState(0).randn(4, 16).astype(np.float32)

    out_lo = lo.forward(Tensor(x))
    out_hi = hi.forward(Tensor(x))
    assert out_lo.dtype == np.dtype(BF16)
    assert out_hi.dtype == np.dtype(np.float32)

    out_lo.sum().backward()
    out_hi.sum().backward()
    for k in ("w", "b"):
        # master params and their grads stay f32
        assert lo.params[k].dtype == np.dtype(np.float32)
        assert lo.params[k].grad.dtype == np.dtype(np.float32)
        _grads_close(lo.params[k].grad, hi.params[k].grad)


def test_conv2d_bf16_forward_dtype_and_f32_master_grads():
    seeder.random_seed(0)
    lo = Conv2D((3, 3, 2, 4), seed=3, compute_dtype=BF16)
    hi = Conv2D((3, 3, 2, 4), seed=3)
    x = np.random.RandomState(1).randn(2, 8, 8, 2).astype(np.float32)

    out_lo = lo.forward(Tensor(x))
    assert out_lo.dtype == np.dtype(BF16)
    out_hi = hi.forward(Tensor(x))
    out_lo.sum().backward()
    out_hi.sum().backward()
    for k in ("w", "b"):
        assert lo.params[k].grad.dtype == np.dtype(np.float32)
        _grads_close(lo.params[k].grad, hi.params[k].grad)


@pytest.mark.parametrize("attn", ["fused", "tape"])
def test_transformer_block_bf16_matches_f32_twin(attn):
    seeder.random_seed(0)
    lo = TransformerBlock(32, 4, causal=True, seed=11, attn=attn,
                          compute_dtype=BF16)
    hi = TransformerBlock(32, 4, causal=True, seed=11, attn=attn)
    x = np.random.RandomState(2).randn(2, 8, 32).astype(np.float32)

    out_lo = lo.forward(Tensor(x))
    out_hi = hi.forward(Tensor(x))
    assert out_lo.dtype == np.dtype(BF16)
    np.testing.assert_allclose(np.asarray(out_lo.data, np.float32),
                               np.asarray(out_hi.data), rtol=0.1, atol=0.1)

    out_lo.sum().backward()
    out_hi.sum().backward()
    for k in lo.params:
        assert lo.params[k].grad.dtype == np.dtype(np.float32), k
        _grads_close(lo.params[k].grad, hi.params[k].grad,
                     rtol=0.1, atol=0.1)


def test_llama_block_bf16_matches_f32_twin():
    seeder.random_seed(0)
    lo = LlamaBlock(32, 4, num_kv_heads=2, seed=13, compute_dtype=BF16)
    hi = LlamaBlock(32, 4, num_kv_heads=2, seed=13)
    x = np.random.RandomState(3).randn(2, 8, 32).astype(np.float32)

    out_lo = lo.forward(Tensor(x))
    out_hi = hi.forward(Tensor(x))
    assert out_lo.dtype == np.dtype(BF16)
    np.testing.assert_allclose(np.asarray(out_lo.data, np.float32),
                               np.asarray(out_hi.data), rtol=0.1, atol=0.1)

    out_lo.sum().backward()
    out_hi.sum().backward()
    for k in lo.params:
        assert lo.params[k].grad.dtype == np.dtype(np.float32), k
        _grads_close(lo.params[k].grad, hi.params[k].grad,
                     rtol=0.1, atol=0.1)


def test_loss_upcasts_bf16_logits_to_f32():
    src = Tensor(np.random.RandomState(4).randn(4, 5).astype(np.float32),
                 requires_grad=True)
    logits = src.astype(BF16)
    labels = np.eye(5, dtype=np.float32)[[0, 2, 1, 4]]
    loss = SoftmaxCrossEntropyLoss()(logits, Tensor(labels))
    assert loss.dtype == np.dtype(np.float32)
    loss.backward()
    # the cotangent re-enters the producing stream in ITS dtype
    assert src.grad.dtype == np.dtype(np.float32)


def _blob_task(n=256, num_in=16, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, num_in) * 3.0
    y = rs.randint(0, classes, size=n)
    x = centers[y] + rs.randn(n, num_in).astype(np.float32)
    onehot = np.eye(classes, dtype=np.float32)[y]
    return x.astype(np.float32), onehot


def test_bf16_mlp_trains_scanned_epochs():
    seeder.random_seed(0)
    x, y = _blob_task()
    net = build_mnist_mlp(num_in=16, hidden=(32, 32), num_out=4,
                          compute_dtype=BF16)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(lr=1e-2))
    losses = model.train_epochs(x, y, n_epochs=3, batch_size=64,
                                shuffle=False)
    losses = np.asarray(losses).reshape(-1)
    assert losses[-1] < losses[0] * 0.5, losses
    # every master param stayed f32 through the jitted updates
    for layer in net.layers:
        for v in layer.params.values():
            assert v.dtype == np.dtype(np.float32)


def test_bf16_transformer_model_train_step():
    seeder.random_seed(0)
    net = build_tiny_transformer(vocab=16, seq_len=8, dim=32, heads=4,
                                 depth=1, num_out=4, compute_dtype=BF16)
    model = Model(net, SoftmaxCrossEntropyLoss(), SGD(lr=0.1))
    rs = np.random.RandomState(5)
    xb = rs.randint(0, 16, size=(8, 8))
    yb = np.eye(4, dtype=np.float32)[rs.randint(0, 4, size=8)]
    l0 = float(model.train_step(xb, yb))
    l1 = float(model.train_step(xb, yb))
    for _ in range(20):
        l1 = float(model.train_step(xb, yb))
    assert np.isfinite([l0, l1]).all()
    assert l1 < l0


def test_bf16_llama_builder_forward_dtype():
    seeder.random_seed(0)
    net = build_tiny_llama(vocab=16, dim=32, heads=4, kv_heads=2,
                           depth=1, compute_dtype=BF16)
    x = np.random.RandomState(6).randint(0, 16, size=(2, 8))
    out = net.forward(Tensor(x))
    # the head Dense runs in bf16; the loss is responsible for the upcast
    assert out.dtype == np.dtype(BF16)
