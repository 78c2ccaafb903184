"""The scanned one-dispatch epoch (Model.train_epochs) is the only fused
multi-step path: it must replay, update for update, the reference-style
eager loop across the optimizer zoo (plain, weight decay, clip_norm), and
the per-step fused train_step where randomness enters (dropout masks,
stochastic rounding of bf16 optimizer slots) — both draw from the same
per-step key fold, so they must agree exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.nn import optimizer as opt
from tinynn_autograd_tpu.nn.layers import Dense, Dropout, ReLU
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.net import Net
from tinynn_autograd_tpu.utils.seeder import random_seed

BATCH, N, EPOCHS = 16, 64, 2


def _data():
    rng = np.random.RandomState(3)
    x = rng.randn(N, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, N)]
    return x, y


def _model(make_opt, dropout=0.0, seed=5):
    random_seed(seed)
    layers = [Dense(16, num_in=8), ReLU()]
    if dropout:
        layers.append(Dropout(dropout))
    layers.append(Dense(4, num_in=16))
    return Model(Net(layers), SoftmaxCrossEntropyLoss(), make_opt())


def _batches(x, y):
    for _ in range(EPOCHS):
        for i in range(0, N, BATCH):
            yield x[i:i + BATCH], y[i:i + BATCH]


def _eager_losses(model, x, y):
    out = []
    for xb, yb in _batches(x, y):
        model.zero_grad()
        loss = model.loss.loss(model.forward(Tensor(xb)), Tensor(yb))
        loss.backward()
        model.step()
        out.append(float(loss.values))
    return np.asarray(out).reshape(EPOCHS, -1)


def _params(model):
    return [{k: np.asarray(v.data) for k, v in layer.params.items()}
            for layer in model.net.layers]


def _assert_same(scanned, other, losses_s, losses_o, rtol=1e-4):
    np.testing.assert_allclose(losses_s, losses_o, rtol=rtol, atol=1e-6)
    for ps, po in zip(_params(scanned), _params(other)):
        for k in ps:
            np.testing.assert_allclose(ps[k], po[k], rtol=rtol, atol=1e-5,
                                       err_msg=k)


ZOO = {
    "sgd": lambda: opt.SGD(0.1),
    "momentum": lambda: opt.Momentum(0.05),
    "rmsprop": lambda: opt.RMSProp(1e-2),
    "adagrad": lambda: opt.Adagrad(0.05),
    "adadelta": lambda: opt.Adadelta(1.0),
    "adam": lambda: opt.Adam(1e-2),
    "lion": lambda: opt.Lion(1e-3),
    "adam_weight_decay": lambda: opt.Adam(1e-2, weight_decay=1e-3),
    "sgd_clip_norm": lambda: opt.SGD(0.5, clip_norm=0.1),
    "adam_clip_norm": lambda: opt.Adam(1e-2, clip_norm=0.05),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_scanned_epochs_match_eager_loop(name):
    x, y = _data()
    scanned = _model(ZOO[name])
    losses_s = np.asarray(scanned.train_epochs(x, y, n_epochs=EPOCHS,
                                               batch_size=BATCH,
                                               shuffle=False))
    eager = _model(ZOO[name])
    losses_e = _eager_losses(eager, x, y)
    _assert_same(scanned, eager, losses_s, losses_e)


STOCHASTIC = {
    "sgd_dropout": (lambda: opt.SGD(0.1), 0.3),
    "adam_dropout": (lambda: opt.Adam(1e-2), 0.3),
    "adam_bf16_slots": (lambda: opt.Adam(1e-2, slot_dtype=jnp.bfloat16),
                        0.0),
    "adam_bf16_slots_sr": (lambda: opt.Adam(
        1e-2, slot_dtype=jnp.bfloat16, stochastic_rounding=True), 0.0),
    "momentum_bf16_slots_sr_dropout": (lambda: opt.Momentum(
        0.05, slot_dtype=jnp.bfloat16, stochastic_rounding=True), 0.2),
}


@pytest.mark.parametrize("name", sorted(STOCHASTIC))
def test_scanned_epochs_match_fused_steps(name):
    make_opt, dropout = STOCHASTIC[name]
    x, y = _data()
    scanned = _model(make_opt, dropout)
    random_seed(11)   # the per-model base key comes from the global stream
    losses_s = np.asarray(scanned.train_epochs(x, y, n_epochs=EPOCHS,
                                               batch_size=BATCH,
                                               shuffle=False))
    stepped = _model(make_opt, dropout)
    random_seed(11)
    losses_f = np.asarray([float(stepped.train_step(xb, yb))
                           for xb, yb in _batches(x, y)]).reshape(EPOCHS, -1)
    _assert_same(scanned, stepped, losses_s, losses_f)
