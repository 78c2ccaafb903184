"""Flash-attention kernel + primitive tests (VERDICT r3 item 1).

The Triton-route Pallas kernels run in interpret mode on CPU (the same
kernel bodies the GPU compiles); the XLA twin is the exact-math reference.
Oracles: float64 naive softmax attention, the existing tape composition
(dot_/softmax_/dot_), and central finite differences through the primitive.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.ops import attention
import tinynn_autograd_tpu.ops as ops
from tinynn_autograd_tpu.utils.seeder import random_seed


def _qkv(b=2, h=2, t=16, d=8, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda: rng.randn(b, h, t, d).astype(np.float32)
    return mk(), mk(), mk()


def _naive(q, k, v, causal, scale):
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q64, k64) * scale
    if causal:
        t = q.shape[2]
        mask = np.tril(np.ones((t, t), bool))
        s = np.where(mask, s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bhqk,bhkd->bhqd", p, v64)


@pytest.mark.parametrize("causal", [False, True])
def test_xla_forward_matches_naive(causal):
    q, k, v = _qkv()
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = attention.mha_fwd(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, scale=scale,
                               impl="xla")
    np.testing.assert_allclose(np.asarray(o), _naive(q, k, v, causal, scale),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [16, 256, 640])
def test_pallas_interpret_matches_xla(causal, t):
    """Interpret mode runs the kernel bodies the GPU compiles — t=256
    exercises the multi-block online-softmax recurrence and the causal
    loop bounds; t=640 a length that is not a power of two (padded to
    whole tiles)."""
    q, k, v = _qkv(b=1, h=4, t=t, d=8, seed=1)
    scale = 0.3
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o_x, lse_x = attention.mha_fwd(*args, causal=causal, scale=scale,
                                   impl="xla")
    o_p, lse_p = attention.mha_fwd(*args, causal=causal, scale=scale,
                                   impl="pallas_interpret")
    np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(lse_p), np.asarray(lse_x),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [16, 256, 640])
def test_pallas_interpret_backward_matches_xla(causal, t):
    q, k, v = _qkv(b=1, h=4, t=t, d=8, seed=2)
    rng = np.random.RandomState(3)
    do = rng.randn(*q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(q.shape[-1])
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o, lse = attention.mha_fwd(*args, causal=causal, scale=scale,
                               impl="xla")
    ref = attention.mha_bwd(*args, o, lse, jnp.asarray(do), causal=causal,
                            scale=scale, impl="xla")
    got = attention.mha_bwd(*args, o, lse, jnp.asarray(do), causal=causal,
                            scale=scale, impl="pallas_interpret")
    for g, r, name in zip(got, ref, "qkv"):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg="d%s mismatch" % name)


@pytest.mark.parametrize("causal", [False, True])
def test_primitive_matches_tape_attention(causal):
    """flash_attention_ must agree with the explicit tape composition
    (batched dot_ + softmax_ + dot_) in value AND all three gradients."""
    q, k, v = _qkv(b=2, h=2, t=12, d=4, seed=4)
    rng = np.random.RandomState(5)
    do = rng.randn(*q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(q.shape[-1])

    qt, kt, vt = (Tensor(x, requires_grad=True) for x in (q, k, v))
    out_f = ops.flash_attention_(qt, kt, vt, causal=causal, scale=scale)
    out_f.backward(Tensor(do))

    q2, k2, v2 = (Tensor(x, requires_grad=True) for x in (q, k, v))
    scores = (q2 @ k2.transpose((0, 1, 3, 2))) * scale
    if causal:
        t = q.shape[2]
        mask = jnp.where(
            jnp.asarray(np.tril(np.ones((t, t), np.float32))) == 1.0,
            0.0, -1e9)
        scores = scores + mask
    out_t = ops.softmax_(scores, axis=-1) @ v2
    out_t.backward(Tensor(do))

    np.testing.assert_allclose(np.asarray(out_f.data),
                               np.asarray(out_t.data), rtol=1e-5, atol=1e-6)
    for a, b, name in [(qt, q2, "dq"), (kt, k2, "dk"), (vt, v2, "dv")]:
        np.testing.assert_allclose(np.asarray(a.grad), np.asarray(b.grad),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_primitive_finite_difference():
    q, k, v = _qkv(b=1, h=1, t=6, d=3, seed=6)
    eps = 1e-3

    def loss_of(qa, ka, va):
        o, _ = attention.mha_fwd(jnp.asarray(qa), jnp.asarray(ka),
                                 jnp.asarray(va), causal=True, impl="xla")
        return float(np.asarray(o).sum() + (np.asarray(o) ** 2).sum())

    qt, kt, vt = (Tensor(x, requires_grad=True) for x in (q, k, v))
    out = ops.flash_attention_(qt, kt, vt, causal=True)
    (ops.sum(out) + ops.sum(out * out)).backward()

    rng = np.random.RandomState(7)
    for arr, ts, name in [(q, qt, "q"), (k, kt, "k"), (v, vt, "v")]:
        for _ in range(5):
            idx = tuple(rng.randint(0, s) for s in arr.shape)
            ap, am = arr.copy(), arr.copy()
            ap[idx] += eps
            am[idx] -= eps
            args_p = [ap if n == name else a
                      for a, n in [(q, "q"), (k, "k"), (v, "v")]]
            args_m = [am if n == name else a
                      for a, n in [(q, "q"), (k, "k"), (v, "v")]]
            fd = (loss_of(*args_p) - loss_of(*args_m)) / (2 * eps)
            np.testing.assert_allclose(float(np.asarray(ts.grad)[idx]), fd,
                                       rtol=2e-2, atol=1e-3,
                                       err_msg="d%s[%s]" % (name, idx))


@pytest.mark.parametrize("causal", [False, True])
def test_transformer_block_fused_matches_tape(causal):
    """TransformerBlock(attn='fused') must be a drop-in for attn='tape':
    same forward, same parameter gradients."""
    from tinynn_autograd_tpu.nn.layers import TransformerBlock

    random_seed(8)
    blk_f = TransformerBlock(dim=16, num_heads=4, causal=causal,
                             attn="fused", seed=3)
    blk_t = TransformerBlock(dim=16, num_heads=4, causal=causal,
                             attn="tape", seed=3)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 8, 16).astype(np.float32)
    do = rng.randn(2, 8, 16).astype(np.float32)

    xf = Tensor(x, requires_grad=True)
    of = blk_f.forward(xf)
    of.backward(Tensor(do))
    xt = Tensor(x, requires_grad=True)
    ot = blk_t.forward(xt)
    ot.backward(Tensor(do))

    np.testing.assert_allclose(np.asarray(of.data), np.asarray(ot.data),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(xf.grad), np.asarray(xt.grad),
                               rtol=1e-4, atol=1e-5)
    for kname in blk_f.params:
        np.testing.assert_allclose(
            np.asarray(blk_f.params[kname].grad),
            np.asarray(blk_t.params[kname].grad),
            rtol=1e-4, atol=1e-5, err_msg=kname)


@pytest.mark.parametrize("t,d", [(1, 8), (16, 64), (100, 64), (1024, 64),
                                 (4096, 128), (640, 96)])
def test_tiles_are_powers_of_two(t, d):
    """Triton tiles: power-of-two edges of at least 16 (Triton's smallest
    dot operand), never wider than the padded length needs."""
    for tiles in (attention._fwd_tiles(t, t, d),
                  attention._bwd_tiles(t, t, d)):
        bq, bk, warps, stages = tiles
        for edge in (bq, bk):
            assert edge >= 16 and edge & (edge - 1) == 0
            assert edge <= max(16, 2 * t)
        assert warps in (4, 8) and stages >= 1


def test_cross_attention_tq_ne_tk():
    """Cross-attention (decoder queries over encoder keys): Tq != Tk must
    match the f64 oracle in value and pass the tape gradient contract."""
    b, h, tq, tk, d = 2, 2, 8, 20, 4
    rng = np.random.RandomState(11)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tk, d).astype(np.float32)
    v = rng.randn(b, h, tk, d).astype(np.float32)
    do = rng.randn(b, h, tq, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)

    o, _ = attention.mha_fwd(jnp.asarray(q), jnp.asarray(k),
                             jnp.asarray(v), scale=scale, impl="xla")
    np.testing.assert_allclose(np.asarray(o),
                               _naive(q, k, v, False, scale),
                               rtol=1e-5, atol=1e-6)

    # grads vs the explicit tape composition
    qt, kt, vt = (Tensor(x, requires_grad=True) for x in (q, k, v))
    out = ops.flash_attention_(qt, kt, vt, scale=scale)
    out.backward(Tensor(do))
    q2, k2, v2 = (Tensor(x, requires_grad=True) for x in (q, k, v))
    out2 = ops.softmax_((q2 @ k2.transpose((0, 1, 3, 2))) * scale,
                        axis=-1) @ v2
    out2.backward(Tensor(do))
    assert qt.grad.shape == (b, h, tq, d)
    assert kt.grad.shape == (b, h, tk, d)
    for a, bb, name in [(qt, q2, "dq"), (kt, k2, "dk"), (vt, v2, "dv")]:
        np.testing.assert_allclose(np.asarray(a.grad), np.asarray(bb.grad),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("tq,tk", [(128, 256), (24, 40)])
def test_cross_attention_pallas_interpret(tq, tk):
    """The kernels themselves handle Tq != Tk, including lengths that are
    not whole tiles (padded keys masked, padded query rows dropped)."""
    b, h, d = 1, 2, 8
    rng = np.random.RandomState(12)
    q = jnp.asarray(rng.randn(b, h, tq, d).astype(np.float32))
    k = jnp.asarray(rng.randn(b, h, tk, d).astype(np.float32))
    v = jnp.asarray(rng.randn(b, h, tk, d).astype(np.float32))
    do = jnp.asarray(rng.randn(b, h, tq, d).astype(np.float32))
    o_x, lse_x = attention.mha_fwd(q, k, v, impl="xla")
    o_p, lse_p = attention.mha_fwd(q, k, v, impl="pallas_interpret")
    np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                               rtol=1e-5, atol=1e-6)
    ref = attention.mha_bwd(q, k, v, o_x, lse_x, do, impl="xla")
    got = attention.mha_bwd(q, k, v, o_x, lse_x, do,
                            impl="pallas_interpret")
    for gg, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(gg), np.asarray(r),
                                   rtol=1e-4, atol=1e-5)


def test_causal_cross_attention_rejected():
    q = jnp.zeros((1, 1, 8, 4))
    k = jnp.zeros((1, 1, 16, 4))
    with pytest.raises(ValueError, match="Tq == Tk"):
        attention.mha_fwd(q, k, k, causal=True)


# ------------------------------------------- attention-probability dropout

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [16, 256])
def test_dropout_pallas_interpret_matches_xla(causal, t):
    """The in-kernel hash masks are a pure function of (head, q, k, seed):
    the Pallas kernels and the XLA fallback must produce IDENTICAL dropout
    — forward and all three gradients — from the same seed."""
    q, k, v = _qkv(b=1, h=4, t=t, d=8, seed=11)
    rng = np.random.RandomState(12)
    do = rng.randn(*q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(q.shape[-1])
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=causal, scale=scale, dropout_rate=0.35,
              dropout_seed=1234)
    o_x, lse_x = attention.mha_fwd(*args, impl="xla", **kw)
    o_p, lse_p = attention.mha_fwd(*args, impl="pallas_interpret", **kw)
    np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(lse_p), np.asarray(lse_x),
                               rtol=1e-5, atol=1e-6)
    ref = attention.mha_bwd(*args, o_x, lse_x, jnp.asarray(do), impl="xla",
                            **kw)
    got = attention.mha_bwd(*args, o_x, lse_x, jnp.asarray(do),
                            impl="pallas_interpret", **kw)
    for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("causal", [False, True])
def test_dropout_primitive_matches_tape_twin_same_mask(impl, causal):
    """Exact fwd+bwd parity with a tape twin that applies the SAME hash
    mask to the materialized softmax probabilities — verifies the dropout
    calculus (normalizer unmasked, delta unchanged, masked dV/ds) against
    the tape's generic VJPs at identical masks."""
    b, h, t, d = 2, 2, 16, 8
    q, k, v = _qkv(b=b, h=h, t=t, d=d, seed=13)
    rng = np.random.RandomState(14)
    do = rng.randn(*q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    rate = 0.4

    key = jax.random.PRNGKey(777)
    seed = jax.random.bits(key, dtype=jnp.uint32)   # flash_attention_'s rule
    qt, kt, vt = (Tensor(x, requires_grad=True) for x in (q, k, v))
    out_f = ops.flash_attention_(qt, kt, vt, causal=causal, scale=scale,
                                 impl=impl, dropout_rate=rate,
                                 dropout_rng=key)
    out_f.backward(Tensor(do))

    # tape twin with the same keep decisions applied post-softmax
    keep = np.asarray(attention.plane_keep_mask(
        seed, b * h, t, t, rate)).reshape(b, h, t, t)
    q2, k2, v2 = (Tensor(x, requires_grad=True) for x in (q, k, v))
    scores = (q2 @ k2.transpose((0, 1, 3, 2))) * scale
    if causal:
        mask = jnp.where(
            jnp.asarray(np.tril(np.ones((t, t), np.float32))) == 1.0,
            0.0, -1e30)
        scores = scores + mask
    probs = ops.softmax_(scores, axis=-1)
    dropped = probs * (keep.astype(np.float32) / (1.0 - rate))
    out_t = dropped @ v2
    out_t.backward(Tensor(do))

    np.testing.assert_allclose(np.asarray(out_f.data),
                               np.asarray(out_t.data), rtol=1e-5, atol=1e-6)
    for a, bb, name in [(qt, q2, "dq"), (kt, k2, "dk"), (vt, v2, "dv")]:
        np.testing.assert_allclose(np.asarray(a.grad), np.asarray(bb.grad),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_dropout_statistics_and_seed_decorrelation():
    """Drop fraction tracks the rate; different seeds give different masks;
    the same seed replays identically; rate=0 is the exact no-op."""
    rate = 0.3
    bits = np.asarray(attention.plane_keep_mask(5, 4, 64, 64, rate))
    frac = 1.0 - bits.mean()
    assert abs(frac - rate) < 0.02, frac

    q, k, v = _qkv(b=1, h=2, t=32, d=8, seed=15)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    o1, _ = attention.mha_fwd(*args, impl="xla", dropout_rate=rate,
                              dropout_seed=1)
    o1b, _ = attention.mha_fwd(*args, impl="xla", dropout_rate=rate,
                               dropout_seed=1)
    o2, _ = attention.mha_fwd(*args, impl="xla", dropout_rate=rate,
                              dropout_seed=2)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o1b))
    assert not np.allclose(np.asarray(o1), np.asarray(o2))
    o0, _ = attention.mha_fwd(*args, impl="xla")
    o0r, _ = attention.mha_fwd(*args, impl="xla", dropout_rate=0.0,
                               dropout_seed=3)
    np.testing.assert_array_equal(np.asarray(o0), np.asarray(o0r))


# ------------------------------------------------------- long sequences

@pytest.mark.parametrize("causal", [False, True])
def test_long_fwd_interpret_matches_xla(causal):
    """t=2048: 32 query blocks, each sweeping up to 32 key blocks (causal:
    only the blocks at or below the diagonal) — parity incl. dropout
    replay."""
    q, k, v = _qkv(b=1, h=2, t=2048, d=8, seed=21)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=causal, scale=0.35, dropout_rate=0.25,
              dropout_seed=77)
    o_x, lse_x = attention.mha_fwd(*args, impl="xla", **kw)
    o_p, lse_p = attention.mha_fwd(*args, impl="pallas_interpret", **kw)
    np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(lse_p), np.asarray(lse_x),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal,t", [(False, 2048), (True, 4096)])
def test_long_bwd_interpret_matches_xla(causal, t):
    """dq/dk/dv parity incl. dropout at long lengths (the dK/dV programs
    start their query sweep at the diagonal block when causal)."""
    q, k, v = _qkv(b=1, h=1, t=t, d=8, seed=22)
    rng = np.random.RandomState(23)
    do = rng.randn(*q.shape).astype(np.float32)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=causal, scale=1.0 / np.sqrt(8), dropout_rate=0.2,
              dropout_seed=11)
    o, lse = attention.mha_fwd(*args, impl="xla", **kw)
    ref = attention.mha_bwd(*args, o, lse, jnp.asarray(do), impl="xla",
                            **kw)
    got = attention.mha_bwd(*args, o, lse, jnp.asarray(do),
                            impl="pallas_interpret", **kw)
    for a, b, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


# -------------------------------------------- GQA, padding, dispatch

@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 2), (4, 1)])
@pytest.mark.parametrize("causal", [False, True])
def test_gqa_interpret_matches_repeated_kv(h, hkv, causal):
    """Native GQA in the kernels (K/V indexed per query group, dK/dV
    summed over the group) against the XLA twin on explicitly repeated
    K/V — forward and all three gradients, with dropout on."""
    b, t, d = 2, 48, 16
    rng = np.random.RandomState(31)
    q = jnp.asarray(rng.randn(b, h, t, d).astype(np.float32))
    k = jnp.asarray(rng.randn(b, hkv, t, d).astype(np.float32))
    v = jnp.asarray(rng.randn(b, hkv, t, d).astype(np.float32))
    do = jnp.asarray(rng.randn(b, h, t, d).astype(np.float32))
    kw = dict(causal=causal, dropout_rate=0.2, dropout_seed=9)
    rep = h // hkv
    kr, vr = jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1)
    o_r, lse_r = attention.mha_fwd(q, kr, vr, impl="xla", **kw)
    o_p, lse_p = attention.mha_fwd(q, k, v, impl="pallas_interpret", **kw)
    np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_r),
                               rtol=1e-5, atol=1e-6)
    dq_r, dk_r, dv_r = attention.mha_bwd(q, kr, vr, o_r, lse_r, do,
                                         impl="xla", **kw)
    dq_p, dk_p, dv_p = attention.mha_bwd(q, k, v, o_p, lse_p, do,
                                         impl="pallas_interpret", **kw)
    fold = lambda g: g.reshape(b, hkv, rep, t, d).sum(axis=2)  # noqa: E731
    np.testing.assert_allclose(np.asarray(dq_p), np.asarray(dq_r),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dk_p), np.asarray(fold(dk_r)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dv_p), np.asarray(fold(dv_r)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("t,d", [(5, 3), (33, 8), (70, 24), (129, 40)])
def test_untileable_lengths_interpret_match_xla(t, d):
    """Lengths and head dims that are not whole power-of-two tiles are
    zero-padded by the wrappers: padded keys must be invisible and padded
    query rows must not leak into dK/dV."""
    for causal in (False, True):
        q, k, v = _qkv(b=1, h=2, t=t, d=d, seed=t)
        do = np.random.RandomState(t + 1).randn(*q.shape).astype(np.float32)
        args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        o_x, lse_x = attention.mha_fwd(*args, causal=causal, impl="xla")
        o_p, lse_p = attention.mha_fwd(*args, causal=causal,
                                       impl="pallas_interpret")
        np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(lse_p), np.asarray(lse_x),
                                   rtol=1e-5, atol=1e-6)
        ref = attention.mha_bwd(*args, o_x, lse_x, jnp.asarray(do),
                                causal=causal, impl="xla")
        got = attention.mha_bwd(*args, o_x, lse_x, jnp.asarray(do),
                                causal=causal, impl="pallas_interpret")
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-5)


def test_kernels_lower_for_the_gpu():
    """Every kernel (forward, dQ, dK/dV — with causal window, GQA and
    dropout all on) lowers to Triton IR for the CUDA platform without a
    GPU present: what the Triton route cannot express fails here."""
    def step(q, k, v, do):
        kw = dict(causal=True, impl="pallas", dropout_rate=0.1,
                  dropout_seed=jnp.uint32(5), window=300)
        o, lse = attention.mha_fwd(q, k, v, **kw)
        return attention.mha_bwd(q, k, v, o, lse, do, **kw)

    spec = jax.ShapeDtypeStruct
    args = (spec((2, 8, 1024, 64), jnp.float32),
            spec((2, 2, 1024, 64), jnp.float32),
            spec((2, 2, 1024, 64), jnp.float32),
            spec((2, 8, 1024, 64), jnp.float32))
    text = jax.jit(step).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 3


def test_auto_dispatch_observes_platform_and_shape(monkeypatch):
    """Auto dispatch: the kernels only on the GPU, only from the measured
    crossover length, only for head dims they tile; an explicit impl or
    the use_impl scope wins; unknown impls are rejected."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    t0 = attention._KERNEL_MIN_T
    assert attention._resolve_impl(None, t0, 64) == "pallas"
    assert attention._resolve_impl(None, t0 * 4, 128) == "pallas"
    assert attention._resolve_impl(None, t0 - 1, 64) == "xla"
    assert attention._resolve_impl(None, t0, 256) == "xla"
    assert attention._resolve_impl("xla", t0, 64) == "xla"
    with attention.use_impl("xla"):
        assert attention._resolve_impl(None, t0, 64) == "xla"
    assert attention._resolve_impl(None, t0, 64) == "pallas"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert attention._resolve_impl(None, t0 * 4, 64) == "xla"
    with pytest.raises(ValueError, match="impl"):
        attention._resolve_impl("mosaic", t0, 64)


@pytest.mark.parametrize("fwd_tiles,bwd_tiles", [
    ((32, 16, 4, 3), (16, 32, 4, 2)),
    ((16, 64, 4, 3), (64, 16, 4, 2)),
    ((64, 32, 8, 2), (32, 64, 8, 2)),
])
def test_unequal_tiles_interpret_match_xla(monkeypatch, fwd_tiles,
                                          bwd_tiles):
    """Query and key tiles of different edges (the tile chooser may pick
    them): causal lengths pad to a multiple of both, and the loop bounds
    stay exact for the causal window and for dropout replay."""
    monkeypatch.setattr(attention, "_fwd_tiles", lambda *a: fwd_tiles)
    monkeypatch.setattr(attention, "_bwd_tiles", lambda *a: bwd_tiles)
    q, k, v = _qkv(b=1, h=2, t=100, d=16, seed=41)
    do = np.random.RandomState(42).randn(*q.shape).astype(np.float32)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for kw in (dict(causal=True, window=37, dropout_rate=0.2,
                    dropout_seed=3), dict(causal=False)):
        o_x, lse_x = attention.mha_fwd(*args, impl="xla", **kw)
        o_p, lse_p = attention.mha_fwd(*args, impl="pallas_interpret", **kw)
        np.testing.assert_allclose(np.asarray(o_p), np.asarray(o_x),
                                   rtol=1e-5, atol=1e-6)
        ref = attention.mha_bwd(*args, o_x, lse_x, jnp.asarray(do),
                                impl="xla", **kw)
        got = attention.mha_bwd(*args, o_x, lse_x, jnp.asarray(do),
                                impl="pallas_interpret", **kw)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-4, atol=1e-5)


def test_kernel_dots_state_their_precision():
    """f32 operands: TF32x3 tensor-core passes on the GPU (f32-accurate),
    exact HIGHEST in the CPU interpreter (which has no TF32x3); narrower
    operands take the default."""
    import jax

    assert (attention._kernel_precision(jnp.float32, interpret=False)
            == jax.lax.DotAlgorithmPreset.TF32_TF32_F32_X3)
    assert (attention._kernel_precision(jnp.float32, interpret=True)
            == jax.lax.Precision.HIGHEST)
    assert attention._kernel_precision(jnp.bfloat16, interpret=False) is None
