"""Recurrent primitives (ops/recurrent.py) and layers (nn.layers.LSTM/GRU).

The reference has no recurrent machinery (SURVEY.md: the only model family
is the MLP), so there is no ported contract here; the oracles are (a) a
hand-rolled per-step loop of the same cell math and (b) ``jax.grad`` over
an identical pure function — the same external-oracle pattern as the
attention tests (the framework itself never uses jax.grad).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.nn import layers, losses, optimizer as opt
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.net import Net
from tinynn_autograd_tpu.ops.recurrent import gru_scan_, lstm_scan_
from tinynn_autograd_tpu.utils import seeder

B, T, D, H = 3, 5, 4, 6


def _rand(rng, *shape):
    return jnp.asarray(rng.standard_normal(shape), jnp.float32)


# ---------------------------------------------------------------- oracles


def _lstm_ref(x, wx, wh, b, h0=None, c0=None):
    """Per-step loop of the identical cell math (pure jnp)."""
    Bn, Tn, _ = x.shape
    Hn = wh.shape[0]
    h = jnp.zeros((Bn, Hn), x.dtype) if h0 is None else h0
    c = jnp.zeros((Bn, Hn), x.dtype) if c0 is None else c0
    outs = []
    for t in range(Tn):
        z = x[:, t] @ wx + h @ wh + b
        i, f, g, o = (jax.nn.sigmoid(z[:, :Hn]), jax.nn.sigmoid(z[:, Hn:2 * Hn]),
                      jnp.tanh(z[:, 2 * Hn:3 * Hn]), jax.nn.sigmoid(z[:, 3 * Hn:]))
        c = f * c + i * g
        h = o * jnp.tanh(c)
        outs.append(h)
    return jnp.stack(outs, axis=1)


def _gru_ref(x, wx, wh, b, h0=None):
    Bn, Tn, _ = x.shape
    Hn = wh.shape[0]
    h = jnp.zeros((Bn, Hn), x.dtype) if h0 is None else h0
    outs = []
    for t in range(Tn):
        a = x[:, t] @ wx + b
        u = h @ wh
        z = jax.nn.sigmoid(a[:, :Hn] + u[:, :Hn])
        r = jax.nn.sigmoid(a[:, Hn:2 * Hn] + u[:, Hn:2 * Hn])
        n = jnp.tanh(a[:, 2 * Hn:] + r * u[:, 2 * Hn:])
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return jnp.stack(outs, axis=1)


def _params(gates, seed=0):
    rng = np.random.default_rng(seed)
    wx = _rand(rng, D, gates * H) * 0.4
    wh = _rand(rng, H, gates * H) * 0.4
    b = _rand(rng, 1, gates * H) * 0.1
    x = _rand(rng, B, T, D)
    return x, wx, wh, b


# ----------------------------------------------------------- value parity


def test_lstm_forward_matches_loop_reference():
    x, wx, wh, b = _params(4)
    out = lstm_scan_(Tensor(x), Tensor(wx), Tensor(wh), Tensor(b))
    np.testing.assert_allclose(np.asarray(out.data),
                               np.asarray(_lstm_ref(x, wx, wh, b)),
                               rtol=0, atol=1e-6)


def test_gru_forward_matches_loop_reference():
    x, wx, wh, b = _params(3)
    out = gru_scan_(Tensor(x), Tensor(wx), Tensor(wh), Tensor(b))
    np.testing.assert_allclose(np.asarray(out.data),
                               np.asarray(_gru_ref(x, wx, wh, b)),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------------ grad parity


def _tape_grads(scan_fn, x, wx, wh, b, cot):
    tx, twx, twh, tb = (Tensor(x, requires_grad=True),
                        Tensor(wx, requires_grad=True),
                        Tensor(wh, requires_grad=True),
                        Tensor(b, requires_grad=True))
    out = scan_fn(tx, twx, twh, tb)
    out.backward(Tensor(cot))
    return tx.grad, twx.grad, twh.grad, tb.grad


@pytest.mark.parametrize("which", ["lstm", "gru"])
def test_grads_match_jax_grad_oracle(which):
    gates = 4 if which == "lstm" else 3
    ref = _lstm_ref if which == "lstm" else _gru_ref
    scan_fn = lstm_scan_ if which == "lstm" else gru_scan_
    x, wx, wh, b = _params(gates, seed=1)
    rng = np.random.default_rng(7)
    cot = _rand(rng, B, T, H)

    def scalar(x_, wx_, wh_, b_):
        return jnp.sum(ref(x_, wx_, wh_, b_) * cot)

    oracle = jax.grad(scalar, argnums=(0, 1, 2, 3))(x, wx, wh, b)
    ours = _tape_grads(scan_fn, x, wx, wh, b, cot)
    for got, want in zip(ours, oracle):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)


def test_lstm_h0_c0_grads_match_oracle():
    x, wx, wh, b = _params(4, seed=2)
    rng = np.random.default_rng(3)
    h0 = _rand(rng, B, H)
    c0 = _rand(rng, B, H)
    cot = _rand(rng, B, T, H)

    def scalar(h0_, c0_):
        return jnp.sum(_lstm_ref(x, wx, wh, b, h0_, c0_) * cot)

    want_h0, want_c0 = jax.grad(scalar, argnums=(0, 1))(h0, c0)
    th0 = Tensor(h0, requires_grad=True)
    tc0 = Tensor(c0, requires_grad=True)
    out = lstm_scan_(Tensor(x), Tensor(wx), Tensor(wh), Tensor(b),
                     h0=th0, c0=tc0)
    out.backward(Tensor(cot))
    np.testing.assert_allclose(np.asarray(th0.grad), np.asarray(want_h0),
                               rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(np.asarray(tc0.grad), np.asarray(want_c0),
                               rtol=2e-5, atol=2e-6)


def test_grads_under_jit_match_eager():
    x, wx, wh, b = _params(4, seed=4)
    cot = jnp.ones((B, T, H), jnp.float32)

    def run(x_, wx_, wh_, b_):
        return _tape_grads(lstm_scan_, x_, wx_, wh_, b_, cot)

    eager = run(x, wx, wh, b)
    jitted = jax.jit(run)(x, wx, wh, b)
    for ge, gj in zip(eager, jitted):
        np.testing.assert_allclose(np.asarray(ge), np.asarray(gj),
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- layer API


def test_layer_shapes_and_last_step_slice():
    seeder.random_seed(0)
    lstm_seq = layers.LSTM(H, num_in=D, return_sequences=True, seed=11)
    lstm_last = layers.LSTM(H, num_in=D, return_sequences=False, seed=11)
    x = Tensor(_rand(np.random.default_rng(0), B, T, D))
    seq = lstm_seq.forward(x)
    last = lstm_last.forward(x)
    assert seq.shape == (B, T, H)
    assert last.shape == (B, H)
    np.testing.assert_allclose(np.asarray(seq.data[:, -1]),
                               np.asarray(last.data), atol=0)


def test_lstm_forget_bias_initializes_to_one():
    lstm = layers.LSTM(H, num_in=D, seed=5)
    bias = np.asarray(lstm.params["b"].data)[0]
    np.testing.assert_array_equal(bias[H:2 * H], 1.0)
    np.testing.assert_array_equal(bias[:H], 0.0)
    np.testing.assert_array_equal(bias[2 * H:], 0.0)


def test_lazy_init_from_first_input():
    gru = layers.GRU(H, seed=6)
    assert not gru.is_init
    out = gru.forward(Tensor(jnp.ones((2, 3, 7), jnp.float32)))
    assert gru.is_init
    assert gru.params["wx"].shape == (7, 3 * H)
    assert out.shape == (2, H)


# ------------------------------------------------- reverse + bidirectional


@pytest.mark.parametrize("which", ["lstm", "gru"])
def test_reverse_scan_equals_flip_run_flip(which):
    """reverse=True must equal: flip the input in time, run the forward
    recurrence, flip the output back (same weights)."""
    gates = 4 if which == "lstm" else 3
    scan_fn = lstm_scan_ if which == "lstm" else gru_scan_
    x, wx, wh, b = _params(gates, seed=6)
    rev = scan_fn(Tensor(x), Tensor(wx), Tensor(wh), Tensor(b),
                  reverse=True)
    flip = scan_fn(Tensor(x[:, ::-1]), Tensor(wx), Tensor(wh), Tensor(b))
    np.testing.assert_allclose(np.asarray(rev.data),
                               np.asarray(flip.data)[:, ::-1],
                               rtol=0, atol=1e-6)


def test_reverse_grads_match_jax_grad_oracle():
    x, wx, wh, b = _params(4, seed=7)
    rng = np.random.default_rng(8)
    cot = _rand(rng, B, T, H)

    def scalar(x_, wx_, wh_, b_):
        # the flip-run-flip definition of the reverse recurrence
        out = _lstm_ref(x_[:, ::-1], wx_, wh_, b_)[:, ::-1]
        return jnp.sum(out * cot)

    oracle = jax.grad(scalar, argnums=(0, 1, 2, 3))(x, wx, wh, b)
    tx, twx, twh, tb = (Tensor(x, requires_grad=True),
                        Tensor(wx, requires_grad=True),
                        Tensor(wh, requires_grad=True),
                        Tensor(b, requires_grad=True))
    out = lstm_scan_(tx, twx, twh, tb, reverse=True)
    out.backward(Tensor(cot))
    for got, want in zip((tx.grad, twx.grad, twh.grad, tb.grad), oracle):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-5, atol=2e-6)


def test_bidirectional_shapes_and_semantics():
    seeder.random_seed(0)
    bi_seq = layers.Bidirectional(
        layers.LSTM(H, num_in=D, return_sequences=True, seed=71))
    bi_last = layers.Bidirectional(
        layers.LSTM(H, num_in=D, return_sequences=False, seed=71))
    # same draws for the twin: copy params across
    for k in bi_seq.params.keys():
        bi_last.params[k] = bi_seq.params[k]
    x = Tensor(_rand(np.random.default_rng(4), B, T, D))
    seq = bi_seq.forward(x)
    last = bi_last.forward(x)
    assert seq.shape == (B, T, 2 * H)
    assert last.shape == (B, 2 * H)
    # keras convention: fwd cell's LAST step ++ bwd cell's FIRST step
    np.testing.assert_allclose(np.asarray(last.data[:, :H]),
                               np.asarray(seq.data[:, -1, :H]), atol=0)
    np.testing.assert_allclose(np.asarray(last.data[:, H:]),
                               np.asarray(seq.data[:, 0, H:]), atol=0)


def test_bidirectional_trains_and_checkpoints(tmp_path):
    """The merged f_*/b_* param view must flow through the fused train
    step, the optimizer, and save/load unchanged."""
    seeder.random_seed(0)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((32, 4, 3)).astype(np.float32)
    y = rng.standard_normal((32, 1)).astype(np.float32)
    model = Model(net=Net([layers.Bidirectional(layers.LSTM(6, seed=81)),
                           layers.Dense(1, seed=82)]),
                  loss=losses.MSELoss(), optimizer=opt.Adam(lr=1e-2))
    first = None
    for _ in range(60):
        loss = float(model.train_step(x, y))
        if first is None:
            first = loss
    assert loss < 0.5 * first, (first, loss)

    pred_before = np.asarray(model.forward(Tensor(x)).data)
    path = str(tmp_path / "bi.ckpt")
    model.save(path)
    model2 = Model(net=Net([layers.Bidirectional(
                                layers.LSTM(6, num_in=3, seed=0)),
                            layers.Dense(1, num_in=12, seed=0)]),
                   loss=losses.MSELoss(), optimizer=opt.Adam(lr=1e-2))
    model2.load(path)
    np.testing.assert_allclose(np.asarray(model2.forward(Tensor(x)).data),
                               pred_before, rtol=0, atol=1e-6)


def test_bidirectional_load_into_lazy_net(tmp_path):
    """Model.load into a Bidirectional built WITHOUT num_in must not
    re-draw over the loaded weights at the first forward (regression:
    the wrapper forwards Model.load's _is_init mark to both inner
    layers)."""
    seeder.random_seed(0)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((8, 4, 3)).astype(np.float32)
    y = rng.standard_normal((8, 1)).astype(np.float32)
    model = Model(net=Net([layers.Bidirectional(layers.LSTM(6, seed=85)),
                           layers.Dense(1, seed=86)]),
                  loss=losses.MSELoss(), optimizer=opt.Adam(lr=1e-2))
    for _ in range(2):
        model.train_step(x, y)
    pred_before = np.asarray(model.forward(Tensor(x)).data)
    path = str(tmp_path / "bi_lazy.ckpt")
    model.save(path)

    seeder.random_seed(123)  # different stream: a re-draw would diverge
    lazy = Model(net=Net([layers.Bidirectional(layers.LSTM(6)),
                          layers.Dense(1)]),
                 loss=losses.MSELoss(), optimizer=opt.Adam(lr=1e-2))
    lazy.load(path)
    np.testing.assert_allclose(np.asarray(lazy.forward(Tensor(x)).data),
                               pred_before, rtol=0, atol=1e-6)


def test_bidirectional_set_parameters_plain_dicts():
    """Net.set_parameters with ordinary dicts (the reference contract)
    must accept the merged f_*/b_* view (regression: keys() returned a
    list, failing the dict_keys equality assert)."""
    src = Net([layers.Bidirectional(layers.LSTM(4, num_in=3, seed=87))])
    dst = Net([layers.Bidirectional(layers.LSTM(4, num_in=3, seed=88))])
    plain = [{k: np.asarray(v.data) for k, v in layer.params.items()}
             for layer in src.layers]
    dst.set_parameters(plain)
    for k in src.layers[0].params.keys():
        np.testing.assert_array_equal(
            np.asarray(dst.layers[0].params[k].data),
            np.asarray(src.layers[0].params[k].data))


def test_bidirectional_rejects_misconfigured_layers():
    with pytest.raises(ValueError):
        layers.Bidirectional(layers.LSTM(4, reverse=True))
    with pytest.raises(ValueError):
        layers.Bidirectional(layers.LSTM(4),
                             backward_layer=layers.LSTM(4))  # not reverse
    with pytest.raises(ValueError):
        layers.Bidirectional(
            layers.LSTM(4, return_sequences=True),
            backward_layer=layers.LSTM(4, reverse=True))


# -------------------------------------------------------- model training


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_sequence_regression_converges(cell):
    """Learn y = sum_t x_t (a pure memory task) with the fused jitted
    train step — the recurrent primitives inside the same one-program
    step as every other layer."""
    seeder.random_seed(0)
    rng = np.random.default_rng(0)
    n = 256
    x = rng.standard_normal((n, 6, 2)).astype(np.float32)
    y = x.sum(axis=1)[:, :1] + 0.5 * x.sum(axis=1)[:, 1:]

    rec = (layers.LSTM(12, seed=21) if cell == "lstm"
           else layers.GRU(12, seed=21))
    model = Model(net=Net([rec, layers.Dense(1, seed=22)]),
                  loss=losses.MSELoss(),
                  optimizer=opt.Adam(lr=1e-2))
    first = None
    for step in range(300):
        loss = float(model.train_step(x, y))
        if first is None:
            first = loss
    assert loss < 0.05 * first, (first, loss)


def test_model_checkpoint_roundtrip(tmp_path):
    seeder.random_seed(0)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 4, 3)).astype(np.float32)
    y = rng.standard_normal((8, 1)).astype(np.float32)
    model = Model(net=Net([layers.LSTM(5, seed=31), layers.Dense(1, seed=32)]),
                  loss=losses.MSELoss(), optimizer=opt.Adam(lr=1e-3))
    for _ in range(3):
        model.train_step(x, y)
    pred_before = np.asarray(model.forward(Tensor(x)).data)
    path = str(tmp_path / "rnn.ckpt")
    model.save(path)

    model2 = Model(net=Net([layers.LSTM(5, num_in=3, seed=0),
                            layers.Dense(1, num_in=5, seed=0)]),
                   loss=losses.MSELoss(), optimizer=opt.Adam(lr=1e-3))
    model2.load(path)
    pred_after = np.asarray(model2.forward(Tensor(x)).data)
    np.testing.assert_allclose(pred_after, pred_before, rtol=0, atol=1e-6)


def test_stacked_rnn_classifier_converges():
    """models.build_rnn_classifier: a 2-layer stack (full-sequence LSTM
    feeding a last-step LSTM) learns a first-token-vs-last-token parity
    task that a bag-of-steps model cannot."""
    from tinynn_autograd_tpu.models import build_rnn_classifier

    seeder.random_seed(0)
    rng = np.random.default_rng(5)
    n, t = 512, 6
    x = rng.standard_normal((n, t, 3)).astype(np.float32)
    y = ((x[:, 0, 0] > 0) ^ (x[:, -1, 0] > 0)).astype(np.int32)
    onehot = np.eye(2, dtype=np.float32)[y]

    net = build_rnn_classifier(num_in=3, num_out=2, hidden=(16, 16),
                               cell="lstm", seed=100)
    model = Model(net=net, loss=losses.SoftmaxCrossEntropyLoss(),
                  optimizer=opt.Adam(lr=5e-3))
    for _ in range(400):
        loss = float(model.train_step(x, onehot))
    pred = np.argmax(np.asarray(model.forward(Tensor(x)).data), axis=1)
    assert (pred == y).mean() > 0.95, (pred == y).mean()
    assert np.isfinite(loss)


def test_remat_wrapped_lstm_matches_unwrapped():
    """Remat(LSTM) must train identically to the unwrapped layer (the
    recurrence is deterministic, so the recompute replays exactly); only
    activation memory differs."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((16, 5, 3)).astype(np.float32)
    y = rng.standard_normal((16, 1)).astype(np.float32)

    def build(wrap):
        seeder.random_seed(0)
        rec = layers.LSTM(8, num_in=3, seed=61)
        if wrap:
            rec = layers.Remat(rec)
        return Model(net=Net([rec, layers.Dense(1, num_in=8, seed=62)]),
                     loss=losses.MSELoss(), optimizer=opt.Adam(lr=1e-2))

    plain, wrapped = build(False), build(True)
    for _ in range(4):
        lp = float(plain.train_step(x, y))
        lw = float(wrapped.train_step(x, y))
        np.testing.assert_allclose(lw, lp, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(wrapped.forward(Tensor(x)).data),
        np.asarray(plain.forward(Tensor(x)).data), rtol=1e-6, atol=1e-7)


def test_recurrent_under_data_parallel_matches_single_device():
    """The recurrence is per-example, so DP (grad psum of per-shard mean
    losses) must track single-device training to float tolerance — the
    lax.scan primitive traces cleanly inside the shard_map'd step."""
    from tinynn_autograd_tpu.parallel import DataParallel, make_mesh

    rng = np.random.default_rng(9)
    x = rng.standard_normal((64, 5, 3)).astype(np.float32)
    y = rng.standard_normal((64, 1)).astype(np.float32)

    def build():
        return Model(net=Net([layers.LSTM(8, num_in=3, seed=51),
                              layers.Dense(1, num_in=8, seed=52)]),
                     loss=losses.MSELoss(), optimizer=opt.SGD(lr=5e-2))

    dp = DataParallel(build(), mesh=make_mesh(8))
    single = build()
    for _ in range(5):
        dp.train_step(x, y)
        single.train_step(x, y)

    for layer_dp, layer_s in zip(dp._params, single._params):
        for k in layer_dp:
            np.testing.assert_allclose(
                np.asarray(layer_dp[k]), np.asarray(layer_s[k]),
                rtol=2e-4, atol=1e-5)


def test_scanned_epoch_tier_handles_recurrent_nets():
    """train_epochs runs recurrent nets (a scan inside the scanned
    epoch)."""
    seeder.random_seed(0)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 4, 3)).astype(np.float32)
    y = rng.standard_normal((64, 1)).astype(np.float32)
    model = Model(net=Net([layers.GRU(6, seed=41), layers.Dense(1, seed=42)]),
                  loss=losses.MSELoss(), optimizer=opt.SGD(lr=1e-2))
    traces = model.train_epochs(x, y, n_epochs=2, batch_size=16)
    assert traces.shape == (2, 4)
    assert np.isfinite(np.asarray(traces)).all()
