"""Transformer family (no reference counterpart): the attention stack is
pure tape algebra (batched dot_, fused softmax_, layer_norm_), so the
standard checks are grads-vs-finite-differences, causality, and end-to-end
learning of a task that REQUIRES attention routing."""

import numpy as np
import pytest

from tinynn_autograd_tpu import Tensor, ops
from tinynn_autograd_tpu.models import build_tiny_transformer
from tinynn_autograd_tpu.nn.layers import Embedding, TransformerBlock
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.optimizer import Adam
from tinynn_autograd_tpu.utils.seeder import random_seed


def test_softmax_primitive_matches_numpy_oracle():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7).astype(np.float32) * 3
    g = rng.randn(5, 7).astype(np.float32)
    t = Tensor(x, requires_grad=True)
    out = ops.softmax_(t, axis=-1)
    out.backward(Tensor(g))

    x64, g64 = x.astype(np.float64), g.astype(np.float64)
    e = np.exp(x64 - x64.max(-1, keepdims=True))
    y = e / e.sum(-1, keepdims=True)
    want_dx = y * (g64 - (g64 * y).sum(-1, keepdims=True))
    np.testing.assert_allclose(np.asarray(out.data), y, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(t.grad), want_dx, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(out.data).sum(-1), 1.0,
                               rtol=1e-6)


def test_transformer_block_grads_finite_diff():
    """Central finite differences through the full block (float32, loose
    tolerance) on a handful of sampled parameters of every matrix."""
    random_seed(2)
    blk = TransformerBlock(dim=16, num_heads=2, mlp_ratio=2)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 16).astype(np.float32) * 0.5
    g = rng.randn(2, 4, 16).astype(np.float32) * 0.1

    def loss_with(param_name, flat_idx, delta):
        p = blk.params[param_name]
        arr = np.asarray(p.data).copy()
        arr.flat[flat_idx] += delta
        blk.params[param_name] = Tensor(arr, requires_grad=True)
        out = blk.forward(Tensor(x))
        val = float((np.asarray(out.data) * g).sum())
        blk.params[param_name] = p
        return val

    out = blk.forward(Tensor(x))
    out.backward(Tensor(g))
    eps = 3e-3
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "g1", "be2"):
        grad = np.asarray(blk.params[name].grad)
        for flat_idx in (0, grad.size // 2):
            num = (loss_with(name, flat_idx, eps)
                   - loss_with(name, flat_idx, -eps)) / (2 * eps)
            got = grad.flat[flat_idx]
            np.testing.assert_allclose(
                got, num, rtol=5e-2, atol=5e-3,
                err_msg="finite-diff mismatch at %s[%d]" % (name, flat_idx))


def test_causal_mask_blocks_future_tokens():
    random_seed(3)
    blk = TransformerBlock(dim=16, num_heads=2, causal=True)
    rng = np.random.RandomState(0)
    x = rng.randn(1, 6, 16).astype(np.float32)
    out1 = np.asarray(blk.forward(Tensor(x)).data)
    x2 = x.copy()
    x2[:, 4:, :] += 10.0  # perturb the future
    out2 = np.asarray(blk.forward(Tensor(x2)).data)
    np.testing.assert_allclose(out1[:, :4], out2[:, :4], rtol=1e-5,
                               atol=1e-6)
    assert not np.allclose(out1[:, 4:], out2[:, 4:])


def test_embedding_grads_accumulate_for_repeated_tokens():
    random_seed(4)
    emb = Embedding(vocab=6, dim=3)
    ids = np.array([[1, 1, 2]])
    out = emb.forward(Tensor(ids))
    out.backward(Tensor(np.ones((1, 3, 3), np.float32)))
    grad = np.asarray(emb.params["w"].grad)
    np.testing.assert_allclose(grad[1], 2.0)  # token 1 used twice
    np.testing.assert_allclose(grad[2], 1.0)
    np.testing.assert_allclose(grad[0], 0.0)


def test_transformer_learns_attention_routing_task():
    """Classify the token at position 0 — solvable only by routing
    position-0 information through attention to the pooled readout."""
    random_seed(0)
    net = build_tiny_transformer(vocab=16, seq_len=8, dim=32, heads=4,
                                 depth=2, num_out=16)
    m = Model(net, SoftmaxCrossEntropyLoss(), Adam(3e-3))
    rng = np.random.RandomState(0)
    x = rng.randint(0, 16, (256, 8))
    y = np.eye(16, dtype=np.float32)[x[:, 0]]
    losses = [float(m.train_step(x, y)) for _ in range(120)]
    assert losses[-1] < 0.05 * losses[0]
    m.set_phase("TEST")
    pred = np.argmax(m.predict(x[:64]).numpy(), axis=1)
    assert (pred == x[:64, 0]).mean() > 0.95


def test_transformer_scanned_epoch_and_checkpoint(tmp_path):
    import os

    random_seed(1)
    net = build_tiny_transformer(vocab=8, seq_len=4, dim=16, heads=2,
                                 depth=1, num_out=8)
    m = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3))
    rng = np.random.RandomState(0)
    x = rng.randint(0, 8, (64, 4))
    y = np.eye(8, dtype=np.float32)[x[:, 0]]
    losses = np.asarray(m.train_epoch(x, y, batch_size=16, shuffle=False))
    assert np.isfinite(losses).all()
    path = os.path.join(str(tmp_path), "tf.pkl")
    m.save(path)
    random_seed(1)
    m2 = Model(build_tiny_transformer(vocab=8, seq_len=4, dim=16, heads=2,
                                      depth=1, num_out=8),
               SoftmaxCrossEntropyLoss(), Adam(1e-3))
    m2.load(path)
    l1 = float(m.train_step(x, y))
    l2 = float(m2.train_step(x, y))
    np.testing.assert_allclose(l1, l2, rtol=1e-5, atol=1e-7)


def test_tiny_lm_learns_deterministic_grammar():
    from tinynn_autograd_tpu.models import build_tiny_lm

    random_seed(5)
    V, T = 11, 8
    net = build_tiny_lm(vocab=V, seq_len=T, dim=32, heads=4, depth=1)
    m = Model(net, SoftmaxCrossEntropyLoss(), Adam(3e-3))
    rng = np.random.RandomState(0)
    eye = np.eye(V, dtype=np.float32)
    losses = []
    for _ in range(150):
        seq = np.empty((32, T + 1), np.int64)
        seq[:, 0] = rng.randint(0, V, 32)
        for t in range(T):
            seq[:, t + 1] = (3 * seq[:, t] + 1) % V
        x, tgt = seq[:, :-1], seq[:, 1:]
        logits = m.forward(Tensor(x)).reshape((32 * T, V))
        m.zero_grad()
        loss_t = m.loss.loss(logits, Tensor(eye[tgt.reshape(-1)]))
        loss_t.backward()
        m.step()
        losses.append(float(loss_t.data))
    assert losses[-1] < 0.05, losses[-1]
    # predictions follow the grammar
    pred = m.forward(Tensor(x)).numpy().argmax(-1)
    assert (pred == (3 * x + 1) % V).mean() > 0.98


# ------------------------------------------------- round 4: block dropout

def test_transformer_dropout_train_vs_test():
    """Residual dropout: TRAIN forwards vary per call; TEST is
    deterministic and equals a zero-dropout twin with the same params."""
    from tinynn_autograd_tpu.nn.layers import TransformerBlock

    random_seed(40)
    blk = TransformerBlock(dim=16, num_heads=4, dropout=0.5, seed=7)
    twin = TransformerBlock(dim=16, num_heads=4, seed=7)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 16).astype(np.float32)

    a = np.asarray(blk.forward(Tensor(x)).data)
    b = np.asarray(blk.forward(Tensor(x)).data)
    assert not np.allclose(a, b)  # fresh masks per TRAIN forward

    blk.set_phase("TEST")
    twin.set_phase("TEST")
    t1 = np.asarray(blk.forward(Tensor(x)).data)
    t2 = np.asarray(blk.forward(Tensor(x)).data)
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_allclose(t1, np.asarray(twin.forward(Tensor(x)).data),
                               rtol=1e-6)


@pytest.mark.parametrize("attn", ["tape", "fused"])
def test_transformer_attn_dropout_both_paths(attn):
    """attn_dropout works under BOTH attention paths (round 5: the fused
    flash kernels replay in-kernel hash masks; previously fused raised)."""
    from tinynn_autograd_tpu.nn.layers import TransformerBlock

    blk = TransformerBlock(dim=16, num_heads=4, attn=attn,
                           attn_dropout=0.3, seed=1)
    rng = np.random.RandomState(1)
    x = Tensor(rng.randn(2, 8, 16).astype(np.float32), requires_grad=True)
    out = blk.forward(x)
    out.backward(Tensor(np.ones((2, 8, 16), np.float32)))
    for k, p in blk.params.items():
        assert np.all(np.isfinite(np.asarray(p.grad))), k
    assert np.all(np.isfinite(np.asarray(x.grad)))
    # fresh masks per TRAIN forward; TEST phase is deterministic identity
    a = np.asarray(blk.forward(Tensor(x.data)).data)
    b = np.asarray(blk.forward(Tensor(x.data)).data)
    assert not np.allclose(a, b)
    blk.set_phase("TEST")
    twin = TransformerBlock(dim=16, num_heads=4, attn=attn, seed=1)
    twin.set_phase("TEST")
    np.testing.assert_allclose(
        np.asarray(blk.forward(Tensor(x.data)).data),
        np.asarray(twin.forward(Tensor(x.data)).data), rtol=1e-6)


def test_transformer_dropout_trains_under_fused_step():
    """The Model threads per-step rng into dropout-carrying blocks (they
    advertise set_rng); the jitted step must draw fresh masks per step
    and still converge on the routing task."""
    from tinynn_autograd_tpu.nn.layers import (
        Dense, GlobalAvgPool1D, TransformerBlock,
    )
    from tinynn_autograd_tpu.nn.net import Net

    random_seed(41)
    net = Net([Dense(16, num_in=8), TransformerBlock(dim=16, num_heads=4,
                                                     dropout=0.2, seed=2),
               GlobalAvgPool1D(), Dense(4, num_in=16)])
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(lr=1e-2))
    rng = np.random.RandomState(0)
    x = rng.randn(32, 8, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 32)]
    losses = [float(model.train_step(x, y)) for _ in range(60)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.7
    # dropout masks change per step: the loss sequence is not constant
    assert len({round(l, 6) for l in losses[:10]}) > 3


def test_transformer_default_has_no_set_rng():
    """Zero-dropout blocks must NOT advertise set_rng (wrappers that
    reject stochastic layers key on it)."""
    from tinynn_autograd_tpu.nn.layers import TransformerBlock

    blk = TransformerBlock(dim=16, num_heads=4)
    assert not hasattr(blk, "set_rng")
    blk_d = TransformerBlock(dim=16, num_heads=4, dropout=0.1)
    assert hasattr(blk_d, "set_rng")


def test_transformer_fused_attn_dropout_trains():
    """Round 5: attn='fused' + attn_dropout + dropout trains end-to-end
    under the jitted step (in-kernel hash-mask dropout in the flash path),
    with per-step mask refresh."""
    from tinynn_autograd_tpu.nn.layers import (
        Dense, GlobalAvgPool1D, TransformerBlock,
    )
    from tinynn_autograd_tpu.nn.net import Net

    random_seed(43)
    net = Net([Dense(16, num_in=8),
               TransformerBlock(dim=16, num_heads=4, attn="fused",
                                dropout=0.1, attn_dropout=0.2, seed=3),
               GlobalAvgPool1D(), Dense(4, num_in=16)])
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(lr=1e-2))
    rng = np.random.RandomState(0)
    x = rng.randn(32, 8, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 32)]
    losses = [float(model.train_step(x, y)) for _ in range(60)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.7
    assert len({round(l, 6) for l in losses[:10]}) > 3
