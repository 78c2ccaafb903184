"""Round-5 regression tests: VERDICT r4 items 7/8/9.

- fit() returns the FULL loss trace (per-step arrays + per-epoch mean and
  final) and surfaces time-to-target-accuracy when asked.
- _config_fingerprint hashes small array hyperparams by VALUE: mutating a
  loss class-weight vector in place must recompile, not silently keep the
  program compiled against the old weights.
- load_mnist checksum/structure verification: a pinned sha256 mismatch and
  a structurally-corrupt pickle both raise instead of producing a bogus
  "real" benchmark number.
"""

import gzip
import os
import pickle

import numpy as np
import pytest

from tinynn_autograd_tpu.nn.evaluator import AccEvaluator
from tinynn_autograd_tpu.nn.layers import Dense, ReLU
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.net import Net
from tinynn_autograd_tpu.nn.optimizer import SGD
from tinynn_autograd_tpu.utils.datasets import file_sha256, load_mnist
from tinynn_autograd_tpu.utils.seeder import random_seed


def _xy(n=64, din=8, dout=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, din).astype(np.float32)
    y = np.eye(dout, dtype=np.float32)[rng.randint(0, dout, n)]
    return x, y


def _model(loss=None, seed=7, lr=0.1):
    random_seed(seed)
    net = Net([Dense(16, num_in=8), ReLU(), Dense(4, num_in=16)])
    return Model(net, loss or SoftmaxCrossEntropyLoss(), SGD(lr=lr))


# --------------------------------------------- VERDICT #7: fit() full trace

def test_fit_returns_full_loss_trace():
    x, y = _xy(n=64)
    m = _model()
    hist = m.fit(x, y, epochs=3, batch_size=16, verbose=False)
    assert len(hist["loss"]) == 3 and len(hist["loss_final"]) == 3
    assert len(hist["loss_steps"]) == 3
    for ep in hist["loss_steps"]:
        assert np.asarray(ep).shape == (4,)  # 64 / 16 steps per epoch
    for mean, final, steps in zip(hist["loss"], hist["loss_final"],
                                  hist["loss_steps"]):
        np.testing.assert_allclose(mean, np.asarray(steps).mean(), rtol=1e-6)
        np.testing.assert_allclose(final, np.asarray(steps)[-1], rtol=1e-6)


def test_fit_time_to_target_stops_early():
    x, y = _xy(n=64)
    m = _model(lr=0.5)
    hist = m.fit(x, y, epochs=200, batch_size=16, verbose=False,
                 eval_data=(x, np.argmax(y, axis=1)),
                 evaluator=AccEvaluator(),
                 target_metric="accuracy", target_value=0.9)
    assert "time_to_target" in hist, "target never reached in 200 epochs"
    tt = hist["time_to_target"]
    assert tt["epochs"] == len(hist["loss"]) < 200
    assert tt["seconds"] > 0 and tt["accuracy"] >= 0.9


# ------------------------------- VERDICT #8: array hyperparams hashed by value

def test_loss_weight_inplace_mutation_recompiles():
    """In-place mutation of the class-weight array must change the compiled
    program (previously fingerprinted by id(), which doesn't change)."""
    x, y = _xy()
    w = np.ones(4, np.float32)
    loss = SoftmaxCrossEntropyLoss(weight=w)
    # _weight is a jnp array copy; mutate the loss's own attr in place via
    # numpy view semantics -> emulate with a numpy-backed weight
    loss._weight = np.ones(4, np.float32)
    m = _model(loss=loss)
    l0 = float(m.train_step(x, y))
    # in-place: same object identity, different values
    loss._weight[:] = [10.0, 0.1, 0.1, 0.1]
    l1 = float(m.train_step(x, y))
    # recompute eagerly what the weighted loss should be now
    loss2 = SoftmaxCrossEntropyLoss(weight=np.array([10.0, 0.1, 0.1, 0.1],
                                                    np.float32))
    from tinynn_autograd_tpu.core.tensor import Tensor

    pred = m.predict(x)
    expected_next = float(loss2.loss(pred, Tensor(y)).data)
    # the *next* step must use the new weights
    l2 = float(m.train_step(x, y))
    np.testing.assert_allclose(l2, expected_next, rtol=1e-4, atol=1e-5)
    assert not np.isclose(l1, l0) or not np.isclose(l2, l1), (
        "weight mutation had no observable effect")


def test_fingerprint_distinguishes_values_same_shape():
    m1 = _model(loss=SoftmaxCrossEntropyLoss(weight=np.ones(4, np.float32)))
    m2 = _model(loss=SoftmaxCrossEntropyLoss(
        weight=np.array([2, 1, 1, 1], np.float32)))
    assert m1._config_fingerprint() != m2._config_fingerprint()
    m3 = _model(loss=SoftmaxCrossEntropyLoss(weight=np.ones(4, np.float32)))
    # same VALUES in distinct objects -> same fingerprint (no spurious
    # recompiles from identity churn)
    assert m1._config_fingerprint()[1] == m3._config_fingerprint()[1]


# ----------------------------------- VERDICT #9: checksum-verified real MNIST

def _fake_mnist_pickle(tmpdir, corrupt=False):
    rng = np.random.RandomState(0)

    def split(n):
        xs = rng.rand(n, 784).astype(np.float32)
        ys = rng.randint(0, 10, n).astype(np.int64)
        return xs, ys

    train, valid, test = split(50000), split(10000), split(10000)
    if corrupt:
        test = (test[0][:, :100], test[1])  # wrong image width
    path = os.path.join(tmpdir, "mnist.pkl.gz")
    with gzip.open(path, "wb") as f:
        pickle.dump((train, valid, test), f)
    return path


def test_load_mnist_sha256_mismatch_raises(tmp_path):
    d = str(tmp_path)
    _fake_mnist_pickle(d)
    with pytest.raises(ValueError, match="sha256"):
        load_mnist(data_dir=d, sha256="0" * 64)


def test_load_mnist_sha256_match_loads(tmp_path):
    d = str(tmp_path)
    path = _fake_mnist_pickle(d)
    (tx, ty), (ex, ey) = load_mnist(data_dir=d, sha256=file_sha256(path))
    assert tx.shape == (60000, 784) and ex.shape == (10000, 784)


def test_load_mnist_structural_corruption_raises(tmp_path):
    d = str(tmp_path)
    _fake_mnist_pickle(d, corrupt=True)
    with pytest.raises(ValueError, match="test split has images"):
        load_mnist(data_dir=d)


def test_attention_dispatch_single_kernel_crossover(monkeypatch):
    """Dispatch rule: on the GPU, auto picks the Triton kernels from the
    measured crossover length _KERNEL_MIN_T up — lengths that are not
    whole tiles included (the wrappers pad them) — and the XLA twin below
    it, for head dims past _HEAD_DIM_MAX, and off the GPU."""
    import jax

    from tinynn_autograd_tpu.ops import attention

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    t0 = attention._KERNEL_MIN_T
    assert attention._resolve_impl(None, 16, 64) == "xla"
    assert attention._resolve_impl(None, t0 - 1, 64) == "xla"
    assert attention._resolve_impl(None, t0, 64) == "pallas"
    assert attention._resolve_impl(None, t0 + 8, 64) == "pallas"  # padded
    assert attention._resolve_impl(None, 2 * t0, 64) == "pallas"
    assert attention._resolve_impl(None, 2 * t0, 2048) == "xla"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert attention._resolve_impl(None, 2 * t0, 64) == "xla"
