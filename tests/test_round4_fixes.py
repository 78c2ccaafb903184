"""Round-4 regression tests: VERDICT r3 items 6/7/9/10 + ADVICE r3 findings.

- jit-cache coherence: mutating optimizer hyperparams after first compile
  recompiles instead of silently running the stale program (model.py
  ``_config_fingerprint``).
- explicit init keys: ``seeder.scope`` / per-layer ``seed=`` pin draws
  independent of global draw order.
- stochastic rounding guards: non-bf16 targets raise instead of silently
  degrading.
- ExpertParallel a2a: drop stats accumulate across multiple MoE layers.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.nn.layers import Dense, MoE, ReLU
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.net import Net
from tinynn_autograd_tpu.nn.optimizer import SGD, Adam
from tinynn_autograd_tpu.utils import seeder
from tinynn_autograd_tpu.utils.seeder import random_seed


def _xy(n=32, din=8, dout=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, din).astype(np.float32)
    y = np.eye(dout, dtype=np.float32)[rng.randint(0, dout, n)]
    return x, y


def _model(lr=0.1, seed=7):
    random_seed(seed)
    net = Net([Dense(16, num_in=8), ReLU(), Dense(4, num_in=16)])
    return Model(net, SoftmaxCrossEntropyLoss(), SGD(lr=lr))


# ------------------------------------------------- VERDICT #6: cache coherence

def test_train_step_recompiles_on_lr_change():
    """With lr=0.0 baked into the first compile, a later optimizer.lr
    mutation must take effect (stale-program bug: params frozen forever)."""
    x, y = _xy()
    m = _model(lr=0.0)
    m.train_step(x, y)
    before = np.asarray(m._params[0]["w"])
    m.train_step(x, y)
    np.testing.assert_allclose(np.asarray(m._params[0]["w"]), before)

    m.optimizer.lr = 0.5
    m.train_step(x, y)
    after = np.asarray(m._params[0]["w"])
    assert not np.allclose(after, before), (
        "optimizer.lr mutation was silently ignored by the cached program")


def test_train_epochs_recompiles_on_lr_change():
    x, y = _xy(n=64)
    m = _model(lr=0.0)
    m.train_epochs(x, y, n_epochs=2, batch_size=16, shuffle=False)
    before = np.asarray(m._params[0]["w"])
    m.optimizer.lr = 0.5
    m.train_epochs(x, y, n_epochs=2, batch_size=16, shuffle=False)
    assert not np.allclose(np.asarray(m._params[0]["w"]), before)


def test_loss_swap_recompiles():
    from tinynn_autograd_tpu.nn.losses import MSELoss

    x, y = _xy()
    m = _model(lr=0.1)
    l_ce = float(m.train_step(x, y))
    m.loss = MSELoss()
    l_mse = float(m.train_step(x, y))
    # the recompiled program must evaluate the NEW loss function
    assert abs(l_ce - l_mse) > 1e-3


# ------------------------------------------------ VERDICT #9: explicit seeds

def test_layer_seed_pins_draws_independent_of_global_order():
    random_seed(0)
    a = Dense(16, num_in=8, seed=5)
    _burn = Dense(16, num_in=8)  # advances the global stream
    b = Dense(16, num_in=8, seed=5)
    np.testing.assert_array_equal(np.asarray(a.params["w"].data),
                                  np.asarray(b.params["w"].data))
    assert not np.allclose(np.asarray(a.params["w"].data),
                           np.asarray(_burn.params["w"].data))


def test_seeder_scope_restores_global_stream():
    random_seed(3)
    k1 = seeder.next_key()
    random_seed(3)
    with seeder.scope(123):
        seeder.next_key()  # consumed from the scoped stream only
    k2 = seeder.next_key()
    np.testing.assert_array_equal(np.asarray(k1), np.asarray(k2))


def test_scope_makes_model_twins_identical():
    """The CLAUDE.md lazy-init footgun, closed: two lazily-built models
    created before either trains draw IDENTICAL params under scope."""
    def build():
        net = Net([Dense(16), ReLU(), Dense(4)])
        with seeder.scope(11):
            net.init((8, 8))
        return net

    n1 = build()
    n2 = build()
    for l1, l2 in zip(n1.layers, n2.layers):
        for k in l1.params:
            if l1.params[k] is not None:
                np.testing.assert_array_equal(
                    np.asarray(l1.params[k].data),
                    np.asarray(l2.params[k].data))


# --------------------------------------- ADVICE: stochastic rounding guards

def test_sr_with_unsupported_slot_dtype_raises():
    with pytest.raises(ValueError, match="bfloat16"):
        Adam(1e-3, slot_dtype=jnp.float16, stochastic_rounding=True)


def test_stochastic_round_cast_rejects_non_bf16():
    from tinynn_autograd_tpu.ops.primitives import stochastic_round_cast

    with pytest.raises(NotImplementedError):
        stochastic_round_cast(jnp.ones((4, 4)), jnp.float16, 0)


# --------------------------------------- ADVICE: a2a stats across MoE layers

def test_ep_a2a_stats_accumulate_across_moe_layers():
    from tinynn_autograd_tpu.parallel import ExpertParallel, make_mesh

    random_seed(9)
    net = Net([Dense(32, num_in=16), ReLU(),
               MoE(num_experts=8, dim=32, hidden=16),
               MoE(num_experts=8, dim=32, hidden=16),
               Dense(4, num_in=32)])
    model = Model(net, SoftmaxCrossEntropyLoss(), SGD(lr=0.05))
    ep = ExpertParallel(model, mesh=make_mesh(8, axis_name="expert"),
                        dispatch="a2a", capacity_factor=1.0,
                        aux_loss_weight=0.0)
    rng = np.random.RandomState(0)
    x = rng.randn(64, 16).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 64)]
    loss = ep.train_step(x, y)
    assert np.isfinite(float(loss))
    stats = ep.last_stats
    per_layer = [int(d) for d in stats["dropped_per_layer"]]
    assert len(per_layer) == 2
    assert int(stats["dropped"]) == sum(per_layer)


# --------------------------------- ADVICE: BatchNorm unbiased running var

def test_batch_norm_running_var_is_bessel_corrected():
    from tinynn_autograd_tpu.nn.layers import BatchNorm

    rng = np.random.RandomState(1)
    x = rng.randn(10, 4).astype(np.float32) * 3.0
    bn = BatchNorm(dim=4, momentum=0.5)
    bn.forward(Tensor(x))
    var_b = x.astype(np.float64).var(axis=0)          # biased
    var_u = var_b * 10.0 / 9.0                         # torch running_var
    np.testing.assert_allclose(np.asarray(bn.buffers["var"]),
                               0.5 * 1.0 + 0.5 * var_u, rtol=1e-5)
