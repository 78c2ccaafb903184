"""Scanned-epoch training path: one device dispatch per epoch must be
numerically identical to the per-step dispatch path (same order, no
shuffle), and converge with on-device shuffling."""

import numpy as np

from tinynn_autograd_tpu.nn.layers import Dense, ReLU
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.net import Net
from tinynn_autograd_tpu.nn.optimizer import Adam, SGD
from tinynn_autograd_tpu.utils.seeder import random_seed


def _toy(seed, opt):
    random_seed(seed)
    net = Net([Dense(16, num_in=8), ReLU(), Dense(4, num_in=16)])
    return Model(net, SoftmaxCrossEntropyLoss(), opt)


def _data(n=64):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)]
    return x, y


def test_epoch_matches_per_step_no_shuffle():
    x, y = _data(64)
    m_epoch = _toy(1, SGD(lr=0.1))
    m_step = _toy(1, SGD(lr=0.1))

    losses = np.asarray(
        m_epoch.train_epoch(x, y, batch_size=16, shuffle=False))
    step_losses = [
        float(m_step.train_step(x[i * 16:(i + 1) * 16], y[i * 16:(i + 1) * 16]))
        for i in range(4)
    ]
    np.testing.assert_allclose(losses, step_losses, rtol=1e-5, atol=1e-6)

    for lp, ls in zip(m_epoch._params, m_step._params):
        for k in lp:
            np.testing.assert_allclose(
                np.asarray(lp[k]), np.asarray(ls[k]), rtol=1e-5, atol=1e-6)


def test_epoch_with_shuffle_converges():
    x, y = _data(128)
    model = _toy(2, Adam(lr=1e-2))
    x_dev, y_dev = model.stage(x, y)
    first = None
    for _ in range(50):
        losses = model.train_epoch(x_dev, y_dev, batch_size=32)
        mean = float(np.asarray(losses).mean())
        first = mean if first is None else first
    assert mean < first * 0.5


def test_epoch_drops_ragged_tail():
    x, y = _data(70)  # 70 % 16 = 6 dropped
    model = _toy(3, SGD(lr=0.01))
    losses = model.train_epoch(x, y, batch_size=16, shuffle=False)
    assert losses.shape == (4,)


def test_train_epochs_one_dispatch_matches_loop():
    # N epochs in one dispatch == N train_epoch calls (no shuffle)
    x, y = _data(64)
    m_multi = _toy(5, SGD(lr=0.05))
    m_loop = _toy(5, SGD(lr=0.05))

    losses_multi = np.asarray(
        m_multi.train_epochs(x, y, n_epochs=3, batch_size=16, shuffle=False))
    assert losses_multi.shape == (3, 4)
    loop = [np.asarray(m_loop.train_epoch(x, y, batch_size=16, shuffle=False))
            for _ in range(3)]
    np.testing.assert_allclose(losses_multi, np.stack(loop),
                               rtol=1e-5, atol=1e-6)
    assert int(m_multi._opt_state["t"]) == 12


def test_train_epochs_fused_matches_scan():
    """The scanned n-epoch dispatch replays exactly the per-step fused
    train_step loop over the same (unshuffled) batches."""
    x, y = _data(64)
    m_f = _toy(6, Adam(lr=1e-2))
    m_s = _toy(6, Adam(lr=1e-2))
    lf = np.asarray([[float(m_f.train_step(x[i:i + 16], y[i:i + 16]))
                      for i in range(0, 64, 16)] for _ in range(3)])
    ls = np.asarray(m_s.train_epochs(x, y, 3, batch_size=16, shuffle=False))
    np.testing.assert_allclose(lf, ls, rtol=1e-4, atol=1e-5)


def test_epoch_then_predict_consistent():
    x, y = _data(64)
    model = _toy(4, Adam(lr=1e-2))
    model.train_epoch(x, y, batch_size=16)
    out = model.predict(x)
    assert out.shape == (64, 4)
    assert np.isfinite(out.numpy()).all()
