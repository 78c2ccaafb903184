"""Rematerialization (gradient checkpointing) tests: ops.remat_ and the
nn.layers.Remat wrapper — grad parity with the plain tape, exact dropout
replay, the memory contract (inner intermediates die after the forward),
and CSE protection (optimization_barrier survives in the lowered HLO).

No reference counterpart: the reference tape unconditionally stores every
intermediate (reference core/ops.py:12-29)."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tinynn_autograd_tpu import Tensor, ops
from tinynn_autograd_tpu.nn.layers import (
    BatchNorm, Dense, ReLU, Remat, TransformerBlock,
)
from tinynn_autograd_tpu.nn.losses import MSELoss, SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.net import Net
from tinynn_autograd_tpu.nn.optimizer import Adam, SGD
from tinynn_autograd_tpu.utils.seeder import random_seed


def setup_module():
    random_seed(11)


# ------------------------------------------------------------ ops.remat_


def test_remat_matches_plain_tape_grads():
    w = Tensor(np.random.randn(8, 8).astype(np.float32), requires_grad=True)
    x = Tensor(np.random.randn(4, 8).astype(np.float32), requires_grad=True)

    def block(t):
        return ops.relu(t @ w) @ w

    plain = block(x)
    plain.backward(np.ones((4, 8), np.float32))
    gx_plain, gw_plain = np.asarray(x.grad), np.asarray(w.grad)

    x.zero_grad(), w.zero_grad()
    rem = ops.remat_(block, x)
    rem.backward(np.ones((4, 8), np.float32))

    np.testing.assert_allclose(np.asarray(x.grad), gx_plain, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(w.grad), gw_plain, rtol=1e-6)


def test_remat_closed_over_param_grads_accumulate_once():
    w = Tensor(np.eye(4, dtype=np.float32), requires_grad=True)
    x = Tensor(np.ones((2, 4), np.float32), requires_grad=True)
    # output consumed by TWO downstream ops: the outer walk must still
    # recompute once (summed cotangent), accumulating w.grad once
    y = ops.remat_(lambda t: t @ w, x)
    z = y * 2.0 + y  # dz/dy = 3
    z.backward(np.ones((2, 4), np.float32))
    cot = np.ones((2, 4), np.float32) * 3.0
    np.testing.assert_allclose(np.asarray(w.grad),
                               np.ones((2, 4)).T @ cot, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(x.grad),
                               cot @ np.eye(4).T, rtol=1e-6)


def test_remat_non_tensor_output_raises():
    with pytest.raises(TypeError):
        ops.remat_(lambda t: (t, t), Tensor([1.0], requires_grad=True))


def test_remat_frees_inner_intermediates():
    """The memory contract: after the forward, no inner intermediate is
    alive; the plain tape keeps them until backward."""
    x = Tensor(np.ones((4, 16), np.float32), requires_grad=True)
    w = Tensor(np.random.randn(16, 16).astype(np.float32),
               requires_grad=True)
    ref_box = {}

    def block(t):
        h = ops.relu(t @ w)  # the intermediate to track
        ref_box["ref"] = weakref.ref(h)
        return h @ w

    plain_out = block(x)
    gc.collect()
    assert ref_box["ref"]() is not None, "plain tape must retain h"
    del plain_out
    gc.collect()

    rem_out = ops.remat_(block, x)
    gc.collect()
    assert ref_box["ref"]() is None, "remat must free h after forward"
    # backward still works (recompute)
    rem_out.backward(np.ones((4, 16), np.float32))
    assert w.grad is not None


def test_remat_second_backward_recomputes():
    w = Tensor(np.full((3, 3), 2.0, np.float32), requires_grad=True)
    x = Tensor(np.ones((2, 3), np.float32), requires_grad=True)
    out = ops.remat_(lambda t: t @ w, x)
    out.backward(np.ones((2, 3), np.float32))
    g1 = np.asarray(x.grad).copy()
    out.backward(np.ones((2, 3), np.float32))  # accumulates a second pass
    np.testing.assert_allclose(np.asarray(x.grad), 2.0 * g1, rtol=1e-6)


# ------------------------------------------------------- Remat layer


def _twin_nets(wrap):
    """Two structurally identical 3-block MLPs with IDENTICAL param draws
    (explicit seeds); one with every block Remat-wrapped."""
    def build(w):
        layers = []
        for i, (nin, nout) in enumerate([(12, 32), (32, 32), (32, 6)]):
            d = Dense(nout, num_in=nin, seed=100 + i)
            layers += [Remat(d) if w else d, ReLU()]
        return Net(layers)
    return build(False), build(wrap)


def test_remat_layer_grad_parity_eager():
    plain, wrapped = _twin_nets(True)
    x = Tensor(np.random.randn(8, 12).astype(np.float32))
    y = Tensor(np.random.randn(8, 6).astype(np.float32))
    loss = MSELoss()

    lp = loss.loss(plain.forward(x), y)
    lp.backward()
    lw = loss.loss(wrapped.forward(x), y)
    lw.backward()

    np.testing.assert_allclose(float(lp.data), float(lw.data), rtol=1e-6)
    for pl, wl in zip(plain.layers, wrapped.layers):
        for k in pl.params:
            np.testing.assert_allclose(
                np.asarray(pl.params[k].grad),
                np.asarray(wl.params[k].grad), rtol=1e-5, atol=1e-7)


def test_remat_dropout_replays_exactly():
    """The replay invariant: with the SAME threaded rng, a Remat-wrapped
    stochastic block produces bit-identical grads to the plain block —
    only possible if the recompute redraws the identical masks."""
    k = jax.random.PRNGKey(3)
    blocks = []
    for wrap in (False, True):
        b = TransformerBlock(16, 2, seed=42, attn="tape",
                             dropout=0.4, attn_dropout=0.3)
        blocks.append(Remat(b) if wrap else b)
    x = np.random.randn(2, 8, 16).astype(np.float32)
    grads = []
    for blk in blocks:
        blk.set_rng(k)
        out = blk.forward(Tensor(x))
        out.backward(np.ones_like(x))
        inner = blk.inner if isinstance(blk, Remat) else blk
        grads.append({n: np.asarray(p.grad)
                      for n, p in inner.params.items()})
    for name in grads[0]:
        np.testing.assert_allclose(grads[0][name], grads[1][name],
                                   rtol=1e-5, atol=1e-7,
                                   err_msg="mask replay diverged at " + name)


def test_remat_model_train_step_parity():
    """Jitted train_step: remat-wrapped model follows the identical loss
    trajectory as its plain twin (dropout off, shared init seeds)."""
    x = np.random.randn(16, 12).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[np.random.randint(0, 6, 16)]
    losses = []
    for wrap in (False, True):
        plain, wrapped = _twin_nets(True)
        net = wrapped if wrap else plain
        m = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3))
        traj = [float(m.train_step(x, y)) for _ in range(5)]
        losses.append(traj)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


def test_remat_hlo_keeps_recompute_barrier():
    """CSE protection: the lowered train step must contain the
    optimization barrier (without it XLA folds the recompute back into
    the forward and the memory saving silently evaporates)."""
    _, wrapped = _twin_nets(True)
    m = Model(wrapped, SoftmaxCrossEntropyLoss(), SGD(0.1))
    x = jnp.ones((4, 12), jnp.float32)
    y = jnp.eye(6, dtype=jnp.float32)[jnp.zeros((4,), jnp.int32)]
    m._ensure_init(x.shape)
    m._prepare_state()
    hlo = jax.jit(m._step_core()).lower(
        m._params, m._opt_state, m._buffers, x, y).as_text()
    assert "optimization_barrier" in hlo or "opt-barrier" in hlo


def test_remat_batchnorm_buffers_flow():
    """Non-trainable state inside a Remat wrapper still updates through
    the fused step's buffers plumbing."""
    net = Net([Remat(Dense(8, num_in=4, seed=5)), Remat(BatchNorm(8)),
               Dense(2, num_in=8, seed=6)])
    m = Model(net, MSELoss(), SGD(0.01))
    x = np.random.randn(16, 4).astype(np.float32)
    y = np.random.randn(16, 2).astype(np.float32)
    m.train_step(x, y)
    m.train_step(x, y)
    bn = net.layers[1].inner
    assert float(jnp.asarray(bn.buffers["count"])) == 2.0
    assert not np.allclose(np.asarray(bn.buffers["mean"]), 0.0)


def test_remat_eval_is_passthrough():
    plain, wrapped = _twin_nets(True)
    plain.set_phase("TEST"), wrapped.set_phase("TEST")
    x = Tensor(np.random.randn(4, 12).astype(np.float32))
    out_p, out_w = plain.forward(x), wrapped.forward(x)
    assert out_w.shape == (4, 6)
    np.testing.assert_allclose(np.asarray(out_p.data),
                               np.asarray(out_w.data), rtol=1e-6)
    # pass-through: in TEST phase the wrapper adds no remat node — the
    # inner tape is the output's own history
    assert any(d["grad_fn"] is not None for d in out_w.dependency)


def test_remat_one_dispatch_epoch():
    """train_epochs with a Remat model: the scanned one-dispatch epoch
    runs the remat step under lax.scan."""
    from tinynn_autograd_tpu.utils.seeder import random_seed as _rs

    _rs(17)
    x = np.random.randn(64, 12).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[np.random.randint(0, 6, 64)]
    _, wrapped = _twin_nets(True)
    m = Model(wrapped, SoftmaxCrossEntropyLoss(), Adam(1e-2))
    losses = np.asarray(m.train_epochs(x, y, n_epochs=25, batch_size=32,
                                       shuffle=False))
    assert losses.shape == (25, 2)
    assert np.isfinite(losses).all()
    assert losses[-1].mean() < losses[0].mean() * 0.7
