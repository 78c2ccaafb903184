"""Optimizer unit tests: each update rule against a hand-rolled numpy
twin of the reference's flat-vector math (reference: core/optimizer.py) —
per-leaf pytree updates must be numerically identical to the reference's
flatten-everything approach since all rules are elementwise."""

import numpy as np

from tinynn_autograd_tpu import Tensor
from tinynn_autograd_tpu.nn.optimizer import (
    Adadelta, Adagrad, Adam, Momentum, RMSProp, SGD,
)
from tinynn_autograd_tpu.nn.scheduler import CosineDecayLR, StepDecayLR


def _run(opt, grads_seq):
    """Feed a sequence of gradient values through the facade; returns the
    per-call steps. Params: single 2-vector."""
    outs = []
    for g in grads_seq:
        params = [{"w": Tensor(np.zeros(2, np.float32))}]
        grads = [{"w": np.asarray(g, np.float32)}]
        steps = opt.compute_step(grads, params)
        outs.append(np.asarray(steps[0]["w"]))
    return outs


def test_sgd():
    steps = _run(SGD(lr=0.1), [[1.0, -2.0]])
    np.testing.assert_allclose(steps[0], [-0.1, 0.2], rtol=1e-6)


def test_momentum():
    g = np.array([1.0, 1.0])
    steps = _run(Momentum(lr=0.1, momentum=0.9), [g, g])
    np.testing.assert_allclose(steps[0], -0.1 * g, rtol=1e-6)
    np.testing.assert_allclose(steps[1], -0.1 * (0.9 * g + g), rtol=1e-6)


def test_adam_matches_numpy_twin():
    lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8
    opt = Adam(lr=lr, beta1=b1, beta2=b2, epsilon=eps)
    rng = np.random.RandomState(0)
    gs = [rng.randn(2).astype(np.float32) for _ in range(5)]

    m = np.zeros(2)
    v = np.zeros(2)
    for t, (g, step) in enumerate(zip(gs, _run(opt, gs)), start=1):
        m += (1 - b1) * (g - m)
        v += (1 - b2) * (g ** 2 - v)
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - b2 ** t)
        expected = -lr * m_hat / (np.sqrt(v_hat) + eps)
        np.testing.assert_allclose(step, expected, rtol=1e-4, atol=1e-7)


def test_rmsprop_matches_numpy_twin():
    lr, decay, mom_c, eps = 0.01, 0.99, 0.5, 1e-8
    opt = RMSProp(lr=lr, decay=decay, momentum=mom_c, epsilon=eps)
    rng = np.random.RandomState(1)
    gs = [rng.randn(2).astype(np.float32) for _ in range(4)]

    ms = np.zeros(2)
    mom = np.zeros(2)
    for g, step in zip(gs, _run(opt, gs)):
        ms += (1 - decay) * (g ** 2 - ms)
        mom = mom_c * mom + lr * g / np.sqrt(ms + eps)
        np.testing.assert_allclose(step, -mom, rtol=1e-4, atol=1e-7)


def test_adagrad_matches_numpy_twin():
    lr, eps = 0.1, 1e-8
    opt = Adagrad(lr=lr, epsilon=eps)
    gs = [np.array([1.0, 2.0], np.float32), np.array([2.0, 1.0], np.float32)]
    G = np.zeros(2)
    for g, step in zip(gs, _run(opt, gs)):
        G += g ** 2
        np.testing.assert_allclose(step, -(lr / np.sqrt(G + eps)) * g,
                                   rtol=1e-5, atol=1e-7)


def test_adadelta_matches_numpy_twin():
    lr, decay, eps = 1.0, 0.9, 1e-8
    opt = Adadelta(lr=lr, decay=decay, epsilon=eps)
    rng = np.random.RandomState(2)
    gs = [rng.randn(2).astype(np.float32) for _ in range(3)]
    Eg = np.zeros(2)
    d = np.zeros(2)
    for g, step in zip(gs, _run(opt, gs)):
        Eg += (1 - decay) * (g ** 2 - Eg)
        delta = g * np.sqrt(d + eps) / np.sqrt(Eg + eps)
        expected = -lr * delta
        d += (1 - decay) * (delta ** 2 - d)
        np.testing.assert_allclose(step, expected, rtol=1e-4, atol=1e-7)


def test_weight_decay_applied():
    # step = -lr*g - wd*param (the rule the reference comments out,
    # reference core/optimizer.py:29-30)
    opt = SGD(lr=0.1, weight_decay=0.01)
    params = [{"w": Tensor(np.array([10.0, -10.0], np.float32))}]
    grads = [{"w": np.array([1.0, 1.0], np.float32)}]
    steps = opt.compute_step(grads, params)
    np.testing.assert_allclose(
        np.asarray(steps[0]["w"]), [-0.1 - 0.1, -0.1 + 0.1],
        rtol=1e-5, atol=1e-7)


def test_multi_layer_structure_preserved():
    opt = Adam(lr=0.001)
    params = [
        {"w": Tensor(np.zeros((3, 2), np.float32)),
         "b": Tensor(np.zeros((1, 2), np.float32))},
        {},
        {"w": Tensor(np.zeros((2, 1), np.float32))},
    ]
    grads = [
        {"w": np.ones((3, 2), np.float32), "b": np.ones((1, 2), np.float32)},
        {},
        {"w": np.ones((2, 1), np.float32)},
    ]
    steps = opt.compute_step(grads, params)
    assert steps[0]["w"].shape == (3, 2)
    assert steps[0]["b"].shape == (1, 2)
    assert steps[1] == {}
    assert steps[2]["w"].shape == (2, 1)


def test_lr_schedule():
    sched = StepDecayLR(lr=1.0, step_size=2, gamma=0.1)
    opt = SGD(lr=sched)
    g = [np.array([1.0, 1.0], np.float32)] * 5
    steps = _run(opt, g)
    # t = 1..5; floor(t/2) = 0,1,1,2,2
    np.testing.assert_allclose(steps[0], [-1.0, -1.0], rtol=1e-5)
    np.testing.assert_allclose(steps[1], [-0.1, -0.1], rtol=1e-5)
    np.testing.assert_allclose(steps[4], [-0.01, -0.01], rtol=1e-5)


def test_cosine_schedule_endpoints():
    sched = CosineDecayLR(lr=1.0, decay_steps=100, alpha=0.1)
    import jax.numpy as jnp

    assert abs(float(sched(jnp.asarray(0))) - 1.0) < 1e-6
    assert abs(float(sched(jnp.asarray(100))) - 0.1) < 1e-6


def test_step_leaf_preserves_dtypes_without_override():
    """Review r3 finding: step_leaf upcasts slots to f32 for the math but
    must hand back slots in their INPUT dtype (stable lax.scan carries for
    non-f32 params) and the step in the gradient's dtype."""
    import jax.numpy as jnp

    from tinynn_autograd_tpu.nn.optimizer import Momentum

    opt = Momentum(0.1)
    g = jnp.ones((4,), jnp.bfloat16)
    slots = {"acc": jnp.zeros((4,), jnp.bfloat16)}
    step, new = opt.step_leaf(g, 0.1, jnp.zeros((), jnp.int32), slots)
    assert new["acc"].dtype == jnp.bfloat16
    assert step.dtype == jnp.bfloat16
    # and f32 in -> f32 out, unchanged math
    g32 = jnp.ones((4,), jnp.float32)
    step32, new32 = opt.step_leaf(g32, 0.1, jnp.zeros((), jnp.int32),
                                  {"acc": jnp.zeros((4,), jnp.float32)})
    assert new32["acc"].dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(step32), -0.1 * np.ones(4),
                               rtol=1e-6)


def test_stochastic_round_cast_unbiased_and_kernel_safe():
    """E[sr(x)] == x elementwise: casting a large array of identical
    values sitting between bf16 grid points must average to ~x, where
    round-to-nearest is biased to one grid point by construction."""
    import jax.numpy as jnp

    from tinynn_autograd_tpu.ops.primitives import stochastic_round_cast

    # 1 + 2^-9 sits a QUARTER of the way between bf16 grid points 1.0 and
    # 1 + 2^-8: nearest always rounds DOWN to 1.0; SR must round up with
    # probability ~0.25
    x = jnp.full((256, 256), 1.0 + 2.0 ** -9, jnp.float32)
    near = np.asarray(x.astype(jnp.bfloat16), np.float32)
    assert (near == 1.0).all()
    sr = np.asarray(stochastic_round_cast(x, jnp.bfloat16, 7), np.float32)
    up_frac = (sr > 1.0).mean()
    assert abs(up_frac - 0.25) < 0.02, up_frac
    np.testing.assert_allclose(sr.mean(), 1.0 + 2.0 ** -9, rtol=3e-5)
    # different seeds give different rounding patterns
    sr2 = np.asarray(stochastic_round_cast(x, jnp.bfloat16, 8), np.float32)
    assert (sr != sr2).mean() > 0.1


def test_stochastic_rounding_fixes_bf16_ema_stall():
    """The motivating property: an EMA whose relative increments are below
    bf16 resolution STALLS under round-to-nearest but tracks the true
    value in expectation under stochastic rounding."""
    import jax.numpy as jnp

    from tinynn_autograd_tpu.ops.primitives import stochastic_round_cast

    target, rate, steps = 1.1, 1e-3, 3000
    v_near = jnp.full((64, 128), 1.0, jnp.bfloat16)
    v_sr = jnp.full((64, 128), 1.0, jnp.bfloat16)
    for t in range(steps):
        upd_n = v_near.astype(jnp.float32) * (1 - rate) + rate * target
        v_near = upd_n.astype(jnp.bfloat16)
        upd_s = v_sr.astype(jnp.float32) * (1 - rate) + rate * target
        v_sr = stochastic_round_cast(upd_s, jnp.bfloat16, t)
    true_v = 1.0 + (target - 1.0) * (1 - (1 - rate) ** steps)  # ~1.095
    assert float(np.asarray(v_near, np.float32).mean()) == 1.0  # stalled
    np.testing.assert_allclose(
        float(np.asarray(v_sr, np.float32).mean()), true_v, rtol=0.02)


def test_clip_norm_matches_torch_semantics():
    """Global-norm clipping: grads jointly scaled by
    min(1, clip/(||g||+1e-6)) BEFORE the update rule."""
    opt = SGD(lr=1.0, clip_norm=1.0)
    params = [{"w": Tensor(np.zeros(2, np.float32)),
               "b": Tensor(np.zeros(2, np.float32))}]
    grads = [{"w": np.array([3.0, 0.0], np.float32),
              "b": np.array([0.0, 4.0], np.float32)}]
    steps = opt.compute_step(grads, params)
    # ||g|| = 5 -> scale 1/5: step = -lr * g/5
    np.testing.assert_allclose(np.asarray(steps[0]["w"]), [-0.6, 0.0],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(steps[0]["b"]), [0.0, -0.8],
                               rtol=1e-5)


def test_clip_norm_noop_below_threshold():
    opt = SGD(lr=1.0, clip_norm=100.0)
    params = [{"w": Tensor(np.zeros(2, np.float32))}]
    grads = [{"w": np.array([3.0, 4.0], np.float32)}]
    steps = opt.compute_step(grads, params)
    np.testing.assert_allclose(np.asarray(steps[0]["w"]), [-3.0, -4.0],
                               rtol=1e-4)


def test_adam_bf16_sr_converges_with_fused_step():
    import jax.numpy as jnp

    from tinynn_autograd_tpu.nn.layers import Dense, ReLU
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.net import Net
    from tinynn_autograd_tpu.utils.seeder import random_seed

    rng = np.random.RandomState(0)
    x = rng.randn(64, 16).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 64)]
    random_seed(31)
    net = Net([Dense(32, num_in=16), ReLU(), Dense(4, num_in=32)])
    m = Model(net, SoftmaxCrossEntropyLoss(),
              Adam(1e-2, slot_dtype=jnp.bfloat16, stochastic_rounding=True))
    losses = [float(m.train_step(x, y)) for _ in range(40)]
    assert losses[-1] < losses[0] * 0.3
    assert m._opt_state["slots"]["v"][0]["w"].dtype == jnp.bfloat16


def test_lion_matches_numpy_twin():
    """Lion (sign momentum) vs a hand-stepped numpy twin over 5 steps."""
    from tinynn_autograd_tpu.nn.optimizer import Lion

    rng = np.random.RandomState(0)
    w = rng.randn(4, 3).astype(np.float32)
    opt = Lion(lr=0.01, beta1=0.9, beta2=0.99)
    params = [{"w": Tensor(w.copy(), requires_grad=True)}]
    m = np.zeros_like(w)
    w_ref = w.copy()
    for step in range(5):
        g = rng.randn(4, 3).astype(np.float32)
        grads = [{"w": g}]
        steps = opt.compute_step(grads, params)
        for k in ("w",):
            params[0][k] += steps[0][k]
        u = np.sign(0.9 * m + 0.1 * g)
        m = 0.99 * m + 0.01 * g
        w_ref -= 0.01 * u
        np.testing.assert_allclose(np.asarray(params[0]["w"].data), w_ref,
                                   rtol=1e-6, atol=1e-7)


def test_lion_trains_through_all_tiers():
    """Lion's single-slot sign rule runs in the fused step AND the
    scanned one-dispatch epoch (generic _step_leaf contract)."""
    import jax.numpy as jnp

    from tinynn_autograd_tpu.models import build_mnist_mlp
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.optimizer import Lion
    from tinynn_autograd_tpu.utils.seeder import random_seed

    rng = np.random.RandomState(0)
    x = rng.randn(64, 784).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 64)]

    random_seed(7)
    m = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Lion(3e-4))
    first = float(m.train_step(x, y))
    for _ in range(20):
        last = float(m.train_step(x, y))
    assert last < first, (first, last)

    random_seed(7)
    m2 = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Lion(3e-4))
    xd, yd = m2.stage(x, y)
    losses = np.asarray(m2.train_epochs(xd, yd, n_epochs=3, batch_size=32))
    assert np.isfinite(losses).all()
    assert losses[-1, -1] < losses[0, 0]
