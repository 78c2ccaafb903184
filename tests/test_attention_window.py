"""Sliding-window (causal local) attention: banded-mask semantics in the
Triton kernels (interpret mode; in-band loop bounds), the XLA twin, the
flash primitive's recompute backward, the block layers, TP, and windowed
KV-cache decoding. Oracles: float64 banded naive attention
and the tape composition with an explicit band mask."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.ops import attention
import tinynn_autograd_tpu.ops as ops
from tinynn_autograd_tpu.utils.seeder import random_seed


def _qkv(b=1, h=2, t=64, d=8, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda: rng.randn(b, h, t, d).astype(np.float32)
    return mk(), mk(), mk()


def _naive_window(q, k, v, window, scale):
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q64, k64) * scale
    t = q.shape[2]
    mask = np.tril(np.ones((t, t), bool))
    if window is not None:
        mask &= ~np.tril(np.ones((t, t), bool), -window)
    s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v64)


@pytest.mark.parametrize("window", [1, 7, 32, 64])
def test_xla_window_forward_matches_naive(window):
    q, k, v = _qkv(t=64)
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, _ = attention.mha_fwd(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), causal=True, scale=scale,
                             impl="xla", window=window)
    np.testing.assert_allclose(
        np.asarray(o), _naive_window(q, k, v, window, scale),
        rtol=1e-5, atol=1e-6)


def test_window_ge_t_equals_plain_causal():
    q, k, v = _qkv(t=32)
    a = attention.mha_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, impl="xla", window=32)[0]
    b = attention.mha_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, impl="xla")[0]
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_window_requires_causal():
    q, k, v = _qkv(t=16)
    with pytest.raises(ValueError, match="causal"):
        attention.mha_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False, impl="xla", window=4)


def test_window_primitive_grads_match_banded_tape(monkeypatch):
    """flash_attention_(window=w) values + q/k/v grads vs the explicit
    tape chain with a banded additive mask (the cross-impl oracle)."""
    t, w = 32, 10
    q, k, v = _qkv(b=2, h=2, t=t, d=8, seed=3)
    cot = np.random.RandomState(4).randn(2, 2, t, 8).astype(np.float32)
    scale = 1.0 / np.sqrt(8)

    tq, tk_, tv = (Tensor(q, requires_grad=True),
                   Tensor(k, requires_grad=True),
                   Tensor(v, requires_grad=True))
    out = ops.flash_attention_(tq, tk_, tv, causal=True, impl="xla",
                               window=w)
    out.backward(Tensor(cot))

    mask = np.tril(np.ones((t, t), np.float32))
    mask *= ~np.tril(np.ones((t, t), bool), -w)
    add = np.where(mask == 1.0, 0.0, -1e9).astype(np.float32)
    rq, rk, rv = (Tensor(q, requires_grad=True),
                  Tensor(k, requires_grad=True),
                  Tensor(v, requires_grad=True))
    scores = (rq @ rk.transpose((0, 1, 3, 2))) * scale + add
    ref = ops.softmax_(scores, axis=-1) @ rv
    ref.backward(Tensor(cot))

    np.testing.assert_allclose(np.asarray(out.data), np.asarray(ref.data),
                               rtol=1e-5, atol=1e-6)
    for got, want in ((tq, rq), (tk_, rk), (tv, rv)):
        np.testing.assert_allclose(np.asarray(got.grad),
                                   np.asarray(want.grad),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("window", [64, 100, 128, 300])
def test_gridded_window_interpret_matches_xla(window):
    """The kernels' in-band loop bounds (t=512 over 64-edge tiles = an 8x8
    tile grid; windows both tile-aligned and not). Forward o/lse AND the
    recompute backward dq/dk/dv."""
    t = 512
    q, k, v = _qkv(b=1, h=2, t=t, d=8, seed=5)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=True, scale=0.3, window=window)
    o_x, lse_x = attention.mha_fwd(*args, impl="xla", **kw)
    o_p, lse_p = attention.mha_fwd(*args, impl="pallas_interpret", **kw)
    np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(lse_p), np.asarray(lse_x),
                               rtol=1e-4, atol=1e-5)

    do = jnp.asarray(
        np.random.RandomState(6).randn(*q.shape).astype(np.float32))
    grads_x = attention.mha_bwd(*args, o_x, lse_x, do, impl="xla", **kw)
    grads_p = attention.mha_bwd(*args, o_p, lse_p, do,
                                impl="pallas_interpret", **kw)
    for gx, gp in zip(grads_x, grads_p):
        np.testing.assert_allclose(np.asarray(gp), np.asarray(gx),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t", [256, 640])
def test_resident_plane_window_interpret_matches_xla(t):
    """A window wider than one tile: t=256 is whole tiles, t=640 is not a
    power of two — both mask the band inside the visited tiles."""
    window = 96
    q, k, v = _qkv(b=1, h=2, t=t, d=8, seed=7)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=True, scale=0.3, window=window)
    o_x, lse_x = attention.mha_fwd(*args, impl="xla", **kw)
    o_p, lse_p = attention.mha_fwd(*args, impl="pallas_interpret", **kw)
    np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                               rtol=1e-4, atol=1e-5)
    do = jnp.asarray(
        np.random.RandomState(8).randn(*q.shape).astype(np.float32))
    grads_x = attention.mha_bwd(*args, o_x, lse_x, do, impl="xla", **kw)
    grads_p = attention.mha_bwd(*args, o_p, lse_p, do,
                                impl="pallas_interpret", **kw)
    for gx, gp in zip(grads_x, grads_p):
        np.testing.assert_allclose(np.asarray(gp), np.asarray(gx),
                                   rtol=1e-4, atol=1e-5)


def test_band_window_interpret_matches_xla():
    """A window spanning several tiles (200 over 64-edge tiles): the
    loops start mid-band and mask the partial tiles at both edges."""
    t, window = 512, 200
    q, k, v = _qkv(b=1, h=2, t=t, d=8, seed=9)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=True, scale=0.3, window=window)
    o_x, lse_x = attention.mha_fwd(*args, impl="xla", **kw)
    o_p, lse_p = attention.mha_fwd(*args, impl="pallas_interpret", **kw)
    np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                               rtol=1e-4, atol=1e-5)
    do = jnp.asarray(
        np.random.RandomState(10).randn(*q.shape).astype(np.float32))
    grads_x = attention.mha_bwd(*args, o_x, lse_x, do, impl="xla", **kw)
    grads_p = attention.mha_bwd(*args, o_p, lse_p, do,
                                impl="pallas_interpret", **kw)
    for gx, gp in zip(grads_x, grads_p):
        np.testing.assert_allclose(np.asarray(gp), np.asarray(gx),
                                   rtol=1e-4, atol=1e-5)


def test_window_with_dropout_interpret_matches_xla():
    """Window + in-kernel dropout compose: the same hash masks replay on
    the banded probabilities (XLA twin and kernels agree bit-for-bit on
    the keep decisions)."""
    t, window = 256, 100
    q, k, v = _qkv(b=1, h=2, t=t, d=8, seed=11)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=True, scale=0.3, window=window, dropout_rate=0.3,
              dropout_seed=jnp.uint32(77))
    o_x, lse_x = attention.mha_fwd(*args, impl="xla", **kw)
    o_p, lse_p = attention.mha_fwd(*args, impl="pallas_interpret", **kw)
    np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                               rtol=1e-4, atol=1e-5)


def test_gqa_window_composes():
    """GQA + window: the grouped twin applies the band to every query
    head of a group; parity vs repeated-KV with the same window."""
    b, h, hkv, t, d = 1, 4, 2, 64, 8
    rng = np.random.RandomState(12)
    q = rng.randn(b, h, t, d).astype(np.float32)
    k = rng.randn(b, hkv, t, d).astype(np.float32)
    v = rng.randn(b, hkv, t, d).astype(np.float32)
    o_g, _ = attention.mha_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, impl="xla",
                               window=20)
    krep = np.repeat(k, 2, axis=1)
    vrep = np.repeat(v, 2, axis=1)
    o_r, _ = attention.mha_fwd(jnp.asarray(q), jnp.asarray(krep),
                               jnp.asarray(vrep), causal=True, impl="xla",
                               window=20)
    np.testing.assert_allclose(np.asarray(o_g), np.asarray(o_r),
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ layers


def test_llama_block_window_fused_matches_tape():
    from tinynn_autograd_tpu.nn.layers import LlamaBlock

    x = np.random.RandomState(13).randn(2, 24, 16).astype(np.float32) * 0.5
    cot = np.random.RandomState(14).randn(2, 24, 16).astype(
        np.float32) * 0.1
    results = []
    for attn in ("tape", "fused"):
        random_seed(101)
        blk = LlamaBlock(dim=16, num_heads=4, num_kv_heads=2, causal=True,
                         attn=attn, attn_window=8)
        tx = Tensor(x, requires_grad=True)
        out = blk.forward(tx)
        out.backward(Tensor(cot))
        results.append((np.asarray(out.data), np.asarray(tx.grad)))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(results[0][1], results[1][1], rtol=1e-3,
                               atol=1e-6)


def test_block_window_blinds_beyond_window():
    """Defining property: one block's output at position p is invariant
    to tokens at positions <= p - window."""
    from tinynn_autograd_tpu.nn.layers import LlamaBlock

    random_seed(102)
    blk = LlamaBlock(dim=16, num_heads=4, causal=True, attn_window=4)
    x = np.random.RandomState(15).randn(1, 12, 16).astype(np.float32)
    out1 = np.asarray(blk.forward(Tensor(x)).data)
    x2 = x.copy()
    x2[:, :7, :] += 10.0  # positions 0..6: invisible to position 11
    out2 = np.asarray(blk.forward(Tensor(x2)).data)
    np.testing.assert_allclose(out1[:, 11], out2[:, 11], rtol=1e-4,
                               atol=1e-5)


def test_window_requires_causal_layer():
    from tinynn_autograd_tpu.nn.layers import LlamaBlock, TransformerBlock

    with pytest.raises(ValueError, match="causal"):
        TransformerBlock(16, 4, causal=False, attn_window=4)
    with pytest.raises(ValueError, match="causal"):
        LlamaBlock(16, 4, causal=False, attn_window=4)


def test_cp_ring_rejects_window_wider_than_chunk():
    """window > T/n cannot ride the one-hop path (the band reaches past
    the neighbor chunk) — clear error pointing at ulysses."""
    from tinynn_autograd_tpu.models import build_tiny_llama
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.optimizer import SGD
    from tinynn_autograd_tpu.parallel import ContextParallel, make_mesh
    from tinynn_autograd_tpu.nn.layers import LlamaBlock
    from tinynn_autograd_tpu.nn.net import Net
    from tinynn_autograd_tpu.nn.layers import Dense, Embedding, RMSNorm

    random_seed(103)
    net = Net([Embedding(8, 16),
               LlamaBlock(16, 4, num_kv_heads=4, attn_window=4),
               RMSNorm(16), Dense(8, num_in=16)])
    cp = ContextParallel(Model(net, SoftmaxCrossEntropyLoss(), SGD(0.1)),
                         mesh=make_mesh(4, axis_name="ctx"))
    x = np.zeros((4, 8), np.int64)   # T/n = 2 < window 4
    y = np.eye(8, dtype=np.float32)[np.zeros((4, 8), np.int64)]
    with pytest.raises(ValueError, match="local chunk"):
        cp.train_step(x, y)


@pytest.mark.parametrize("family", ["llama", "classic"])
def test_cp_windowed_one_hop_matches_single_device(family):
    """window <= T/n: ring CP takes the ONE-HOP neighbor-exchange path
    (a single ppermute instead of the n-1-hop ring) — must train
    identically to the single-device windowed model, both families."""
    from tinynn_autograd_tpu.models import (
        build_tiny_llama, build_tiny_transformer,
    )
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.optimizer import SGD
    from tinynn_autograd_tpu.parallel import ContextParallel, make_mesh

    seq, mesh = 16, 4   # T/n = 4, window 3 < 4

    def mk(seed):
        random_seed(seed)
        if family == "llama":
            net = build_tiny_llama(vocab=16, dim=32, heads=8, kv_heads=4,
                                   depth=2, attn_window=3)
        else:
            net = build_tiny_transformer(vocab=16, seq_len=seq, dim=32,
                                         heads=8, depth=2, num_out=16,
                                         causal=True, attn_window=3)
        return Model(net, SoftmaxCrossEntropyLoss(), SGD(lr=0.1))

    rng = np.random.RandomState(0)
    x = rng.randint(0, 16, (8, seq))
    y = (np.eye(16, dtype=np.float32)[(x + 1) % 16] if family == "llama"
         else np.eye(16, dtype=np.float32)[x[:, 0]])
    cp = ContextParallel(mk(1), mesh=make_mesh(mesh, axis_name="ctx"))
    ref = mk(1)
    for _ in range(3):
        np.testing.assert_allclose(float(cp.train_step(x, y)),
                                   float(ref.train_step(x, y)),
                                   rtol=5e-5, atol=1e-6)
    for layer_cp, layer_ref in zip(cp.gather_params(), ref._params):
        for kk in layer_ref:
            np.testing.assert_allclose(
                layer_cp[kk], np.asarray(layer_ref[kk]),
                rtol=3e-4, atol=1e-5)


def test_tp_windowed_llama_matches_single_device():
    """Plain TP runs windowed blocks through layer._mask — parity with
    the single-device fused path (cross-impl window equivalence)."""
    from tinynn_autograd_tpu.nn.layers import (
        Dense, Embedding, LlamaBlock, RMSNorm,
    )
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.net import Net
    from tinynn_autograd_tpu.nn.optimizer import SGD
    from tinynn_autograd_tpu.parallel import TensorParallel, make_mesh

    def mk(seed):
        random_seed(seed)
        net = Net([Embedding(16, 32),
                   LlamaBlock(32, 8, num_kv_heads=4, attn_window=4),
                   RMSNorm(32), Dense(16, num_in=32)])
        return Model(net, SoftmaxCrossEntropyLoss(), SGD(0.1))

    rng = np.random.RandomState(0)
    x = rng.randint(0, 16, (8, 8))
    y = np.eye(16, dtype=np.float32)[(x + 1) % 16]
    tp = TensorParallel(mk(1), mesh=make_mesh(4, axis_name="model"))
    ref = mk(1)
    for _ in range(3):
        np.testing.assert_allclose(float(tp.train_step(x, y)),
                                   float(ref.train_step(x, y)),
                                   rtol=5e-5, atol=1e-6)


# ------------------------------------------------------------------ decode


def test_windowed_llama_generate_matches_full_forward():
    from tinynn_autograd_tpu.models import generate
    from tinynn_autograd_tpu.models.transformer import build_tiny_llama
    from tinynn_autograd_tpu.nn.layers import (
        Dense, Embedding, LlamaBlock, RMSNorm,
    )
    from tinynn_autograd_tpu.nn.net import Net

    random_seed(104)
    net = Net([Embedding(11, 16),
               LlamaBlock(16, 4, num_kv_heads=2, attn_window=4),
               LlamaBlock(16, 4, num_kv_heads=2, attn_window=4),
               RMSNorm(16), Dense(11, num_in=16)])
    net.init((2, 6))
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, 11, (2, 6))
    n_new = 7
    out = np.asarray(generate(net, prompt, n_new))

    ids = prompt.copy()
    for _ in range(n_new):
        logits = net.forward(Tensor(jnp.asarray(ids))).data
        nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        ids = np.concatenate([ids, nxt[:, None].astype(ids.dtype)], axis=1)
    np.testing.assert_array_equal(out, ids)


def test_band_backward_window_interpret_matches_xla():
    """The backward kernels' window bounds in both sweeps: dQ programs
    start their key sweep at the band's lower edge, dK/dV programs stop
    their query sweep at its upper edge — a bound off by one tile would
    ship as silent wrong gradients in causal-window training."""
    t, window = 512, 200
    q, k, v = _qkv(b=1, h=2, t=t, d=8, seed=16)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=True, scale=0.3, window=window)
    o_x, lse_x = attention.mha_fwd(*args, impl="xla", **kw)
    do = jnp.asarray(
        np.random.RandomState(17).randn(*q.shape).astype(np.float32))
    grads_x = attention.mha_bwd(*args, o_x, lse_x, do, impl="xla", **kw)
    grads_p = attention.mha_bwd(*args, o_x, lse_x, do,
                                impl="pallas_interpret", **kw)
    for gx, gp in zip(grads_x, grads_p):
        np.testing.assert_allclose(np.asarray(gp), np.asarray(gx),
                                   rtol=1e-4, atol=1e-5)
