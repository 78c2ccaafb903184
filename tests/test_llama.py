"""Modern-LLM components (no reference counterpart): rms_norm_/rope_/silu_
primitives vs jax.grad oracles, the LlamaBlock (RMSNorm + RoPE + GQA +
SwiGLU) vs a pure-jax twin of the identical math, GQA head-grouping
semantics, end-to-end learning, and GQA KV-cache decoding with top-k/top-p
sampling. The framework never uses jax.grad — the oracles here are
external referees, same convention as tests/test_recurrent.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu import Tensor, ops
from tinynn_autograd_tpu.models import build_tiny_llama
from tinynn_autograd_tpu.models.generate import _filter_logits, generate
from tinynn_autograd_tpu.nn.layers import LlamaBlock, RMSNorm
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.optimizer import Adam
from tinynn_autograd_tpu.utils.seeder import random_seed


def _rand(*shape, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return np.asarray(rng.randn(*shape) * scale, dtype=np.float32)


# ---------------------------------------------------------------- primitives


def test_rms_norm_matches_jax_oracle():
    x = _rand(3, 5, 16, seed=0)
    g = _rand(1, 16, seed=1)
    cot = _rand(3, 5, 16, seed=2)
    eps = 1e-6

    tx = Tensor(x, requires_grad=True)
    tg = Tensor(g, requires_grad=True)
    out = ops.rms_norm_(tx, tg, eps=eps)
    out.backward(Tensor(cot))

    def f(xa, ga):
        r = jax.lax.rsqrt((xa * xa).mean(-1, keepdims=True) + eps)
        return (xa * r * ga * cot).sum()

    r = jax.lax.rsqrt((jnp.asarray(x) ** 2).mean(-1, keepdims=True) + eps)
    want = np.asarray(jnp.asarray(x) * r * jnp.asarray(g))
    np.testing.assert_allclose(np.asarray(out.data), want, rtol=1e-5,
                               atol=1e-6)
    dx, dg = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    np.testing.assert_allclose(np.asarray(tx.grad), np.asarray(dx),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(tg.grad), np.asarray(dg),
                               rtol=1e-4, atol=1e-6)


def test_silu_matches_jax_oracle():
    x = _rand(4, 7, seed=3, scale=2.0)
    cot = _rand(4, 7, seed=4)
    t = Tensor(x, requires_grad=True)
    out = ops.silu_(t)
    out.backward(Tensor(cot))
    np.testing.assert_allclose(np.asarray(out.data),
                               np.asarray(jax.nn.silu(jnp.asarray(x))),
                               rtol=1e-6)
    dx = jax.grad(lambda a: (jax.nn.silu(a) * cot).sum())(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(t.grad), np.asarray(dx),
                               rtol=1e-5, atol=1e-7)


def _jax_rope(x, base=10000.0, positions=None):
    t, d = x.shape[-2], x.shape[-1]
    half = d // 2
    pos = (jnp.arange(t, dtype=jnp.float32) if positions is None
           else jnp.asarray(positions, jnp.float32))
    inv = base ** (-jnp.arange(half, dtype=jnp.float32) / half)
    ang = pos[:, None] * inv[None, :]
    cos, sin = jnp.cos(ang), jnp.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def test_rope_values_and_grads():
    x = _rand(2, 3, 6, 8, seed=5)  # [B, H, T, d]
    cot = _rand(2, 3, 6, 8, seed=6)
    t = Tensor(x, requires_grad=True)
    out = ops.rope_(t)
    out.backward(Tensor(cot))
    np.testing.assert_allclose(np.asarray(out.data),
                               np.asarray(_jax_rope(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    dx = jax.grad(lambda a: (_jax_rope(a) * cot).sum())(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(t.grad), np.asarray(dx),
                               rtol=1e-4, atol=1e-6)


def test_rope_is_norm_preserving_and_position_zero_identity():
    x = _rand(1, 2, 5, 16, seed=7)
    y = np.asarray(ops.rope_(Tensor(x)).data)
    # rotation: per-position L2 norm unchanged
    np.testing.assert_allclose(np.linalg.norm(y, axis=-1),
                               np.linalg.norm(x, axis=-1), rtol=1e-5)
    # position 0 rotates by angle 0 -> identity
    np.testing.assert_allclose(y[..., 0, :], x[..., 0, :], rtol=1e-6)


def test_rope_relative_position_property():
    """RoPE's defining property: <rope(q, m), rope(k, n)> depends on the
    positions only through m - n."""
    d = 8
    q = _rand(1, 1, 1, d, seed=8)
    k = _rand(1, 1, 1, d, seed=9)

    def dot_at(m, n):
        qr = np.asarray(ops.rope_(Tensor(q), positions=np.array([m])).data)
        kr = np.asarray(ops.rope_(Tensor(k), positions=np.array([n])).data)
        return float((qr * kr).sum())

    np.testing.assert_allclose(dot_at(3, 1), dot_at(7, 5), rtol=1e-5)
    np.testing.assert_allclose(dot_at(10, 4), dot_at(6, 0), rtol=1e-5)


def test_rope_odd_dim_raises():
    with pytest.raises(ValueError, match="even"):
        ops.rope_(Tensor(_rand(1, 2, 3, 7)))


# --------------------------------------------------------------- LlamaBlock


def _jax_llama_block(params, x, h, hkv, eps, base, causal):
    """Pure-jax twin of LlamaBlock.forward (the external oracle)."""
    def rms(a, g):
        return a * jax.lax.rsqrt((a * a).mean(-1, keepdims=True) + eps) * g

    b, t, d = x.shape
    hd = d // h
    xn = rms(x, params["g1"])
    q = (xn @ params["wq"]).reshape(b, t, h, hd).transpose(0, 2, 1, 3)
    k = (xn @ params["wk"]).reshape(b, t, hkv, hd).transpose(0, 2, 1, 3)
    v = (xn @ params["wv"]).reshape(b, t, hkv, hd).transpose(0, 2, 1, 3)
    q, k = _jax_rope(q, base), _jax_rope(k, base)
    if hkv != h:
        rep = h // hkv
        k = jnp.repeat(k, rep, axis=1)
        v = jnp.repeat(v, rep, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(hd)
    if causal:
        s = jnp.where(np.tril(np.ones((t, t), bool)), s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    ctx = jnp.einsum("bhqk,bhkd->bhqd", p, v).transpose(0, 2, 1, 3)
    x = x + ctx.reshape(b, t, d) @ params["wo"]
    yn = rms(x, params["g2"])
    return x + (jax.nn.silu(yn @ params["w1"]) * (yn @ params["w3"])) \
        @ params["w2"]


@pytest.mark.parametrize("hkv,causal", [(4, True), (2, True), (1, False)])
def test_llama_block_matches_jax_twin(hkv, causal):
    """Forward AND every parameter/input grad vs jax.grad over the
    pure-jax twin of the identical math (GQA at group sizes 1, 2, 4)."""
    random_seed(11)
    blk = LlamaBlock(dim=16, num_heads=4, num_kv_heads=hkv, causal=causal,
                     attn="tape")
    x = _rand(2, 6, 16, seed=10, scale=0.5)
    cot = _rand(2, 6, 16, seed=11, scale=0.1)
    params = {k: jnp.asarray(v.data) for k, v in blk.params.items()}

    tx = Tensor(x, requires_grad=True)
    out = blk.forward(tx)
    out.backward(Tensor(cot))

    want = _jax_llama_block(params, jnp.asarray(x), 4, hkv, blk.eps,
                            blk.rope_base, causal)
    np.testing.assert_allclose(np.asarray(out.data), np.asarray(want),
                               rtol=2e-4, atol=1e-5)

    def scalar(params, xin):
        return (_jax_llama_block(params, xin, 4, hkv, blk.eps,
                                 blk.rope_base, causal) * cot).sum()

    dparams, dx = jax.grad(scalar, argnums=(0, 1))(params, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(tx.grad), np.asarray(dx),
                               rtol=1e-3, atol=1e-5)
    for name in blk.params:
        np.testing.assert_allclose(
            np.asarray(blk.params[name].grad), np.asarray(dparams[name]),
            rtol=1e-3, atol=1e-5, err_msg="param grad mismatch: %s" % name)


def test_llama_block_fused_matches_tape():
    """attn='fused' (the flash primitive's XLA fallback on CPU) agrees
    with the explicit tape chain, values and grads."""
    x = _rand(2, 8, 16, seed=12, scale=0.5)
    cot = _rand(2, 8, 16, seed=13, scale=0.1)
    results = []
    for attn in ("tape", "fused"):
        random_seed(21)
        blk = LlamaBlock(dim=16, num_heads=4, num_kv_heads=2, causal=True,
                         attn=attn)
        tx = Tensor(x, requires_grad=True)
        out = blk.forward(tx)
        out.backward(Tensor(cot))
        results.append((np.asarray(out.data), np.asarray(tx.grad),
                        {k: np.asarray(v.grad) for k, v in
                         blk.params.items()}))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(results[0][1], results[1][1], rtol=1e-3,
                               atol=1e-6)
    for name in results[0][2]:
        np.testing.assert_allclose(results[0][2][name], results[1][2][name],
                                   rtol=1e-3, atol=1e-6,
                                   err_msg="grad mismatch: %s" % name)


def test_gqa_param_shapes_and_cache_shrink():
    blk = LlamaBlock(dim=32, num_heads=8, num_kv_heads=2)
    assert tuple(blk.shapes["wq"]) == (32, 32)
    assert tuple(blk.shapes["wk"]) == (32, 8)   # 2 kv heads * hd 4
    assert tuple(blk.shapes["wv"]) == (32, 8)
    # SwiGLU hidden: round(32 * 8/3 / 8) * 8 = 88
    assert blk.hidden == 88
    assert tuple(blk.shapes["w3"]) == (32, 88)
    # no biases, no beta shifts
    assert set(blk.shapes) == {"wq", "wk", "wv", "wo", "w1", "w2", "w3",
                               "g1", "g2"}


def test_llama_causality():
    random_seed(31)
    blk = LlamaBlock(dim=16, num_heads=4, num_kv_heads=2, causal=True)
    x = _rand(1, 6, 16, seed=14)
    out1 = np.asarray(blk.forward(Tensor(x)).data)
    x2 = x.copy()
    x2[:, 4:, :] += 10.0
    out2 = np.asarray(blk.forward(Tensor(x2)).data)
    np.testing.assert_allclose(out1[:, :4], out2[:, :4], rtol=1e-5,
                               atol=1e-6)


def test_rmsnorm_layer_lazy_init_and_forward():
    layer = RMSNorm()
    x = _rand(4, 10, seed=15, scale=3.0)
    out = np.asarray(layer.forward(Tensor(x)).data)
    assert layer.param_shapes == {"g": (1, 10)}
    r = 1.0 / np.sqrt((x.astype(np.float64) ** 2).mean(-1, keepdims=True)
                      + 1e-6)
    np.testing.assert_allclose(out, x * r, rtol=1e-5)


def test_tiny_llama_learns_cyclic_grammar_and_decodes_it():
    """End-to-end: the llama family trains through Model.train_step and
    the GQA KV-cache decode continues the learned grammar."""
    vocab, seq = 8, 10
    random_seed(41)
    net = build_tiny_llama(vocab=vocab, dim=32, heads=4, kv_heads=2,
                           depth=1)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-2))
    rng = np.random.RandomState(0)
    starts = rng.randint(0, vocab, 64)
    x = (starts[:, None] + np.arange(seq)[None, :]) % vocab
    y = np.eye(vocab, dtype=np.float32)[(x + 1) % vocab]
    first = last = None
    for i in range(80):
        loss = model.train_step(x, y.reshape(64, seq, vocab))
        if i == 0:
            first = float(loss)
        last = float(loss)
    assert last < first * 0.2, (first, last)
    prompt = np.array([[3, 4, 5], [0, 1, 2]], np.int64)
    out = np.asarray(generate(net, prompt, 4))
    want = np.array([[3, 4, 5, 6, 7, 0, 1], [0, 1, 2, 3, 4, 5, 6]])
    np.testing.assert_array_equal(out, want)


def test_llama_checkpoint_roundtrip(tmp_path):
    random_seed(51)
    net = build_tiny_llama(vocab=9, dim=16, heads=4, kv_heads=1, depth=2)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3))
    x = np.random.RandomState(1).randint(0, 9, (4, 6))
    y = np.eye(9, dtype=np.float32)[np.roll(x, -1, axis=1)]
    model.train_step(x, y)
    path = str(tmp_path / "llama.ckpt")
    model.save(path)

    random_seed(52)
    net2 = build_tiny_llama(vocab=9, dim=16, heads=4, kv_heads=1, depth=2)
    model2 = Model(net2, SoftmaxCrossEntropyLoss(), Adam(1e-3))
    model2.load(path)
    a = model.forward(Tensor(x)).data
    b = model2.forward(Tensor(x)).data
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


# ----------------------------------------------------------- llama decoding


def _llama_net(seed=0, vocab=17, dim=16, heads=4, kv_heads=2, depth=2):
    random_seed(seed)
    net = build_tiny_llama(vocab=vocab, dim=dim, heads=heads,
                           kv_heads=kv_heads, depth=depth)
    net.init((2, 8))
    return net, vocab


def test_llama_greedy_generate_matches_full_forward():
    net, vocab = _llama_net()
    rng = np.random.RandomState(0)
    prompt = rng.randint(0, vocab, (2, 4))
    n_new = 6
    out = np.asarray(generate(net, prompt, n_new))
    assert out.shape == (2, 4 + n_new)
    np.testing.assert_array_equal(out[:, :4], prompt)

    # oracle: re-run the full training forward (no positional table — the
    # llama net accepts the growing length directly)
    ids = prompt.copy()
    for _ in range(n_new):
        logits = net.forward(Tensor(jnp.asarray(ids))).data
        nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        ids = np.concatenate([ids, nxt[:, None].astype(ids.dtype)], axis=1)
    np.testing.assert_array_equal(out, ids)


def test_llama_generate_mqa_cache_and_determinism():
    net, vocab = _llama_net(seed=1, kv_heads=1)  # MQA
    prompt = np.zeros((3, 2), np.int64)
    key = jax.random.PRNGKey(7)
    a = np.asarray(generate(net, prompt, 5, temperature=1.0, rng=key))
    b = np.asarray(generate(net, prompt, 5, temperature=1.0, rng=key))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (3, 7)
    assert (a >= 0).all() and (a < vocab).all()


# ------------------------------------------------------------ sampling math


def test_filter_logits_top_k():
    logits = jnp.asarray([[1.0, 3.0, 2.0, -1.0]])
    out = np.asarray(_filter_logits(logits, top_k=2, top_p=None))
    assert out[0, 1] == 3.0 and out[0, 2] == 2.0
    assert out[0, 0] < -1e29 and out[0, 3] < -1e29


def test_filter_logits_top_p():
    # probs ~ [0.643, 0.237, 0.087, 0.032]: top_p=0.7 keeps the first two
    logits = jnp.log(jnp.asarray([[0.643, 0.237, 0.087, 0.032]]))
    out = np.asarray(_filter_logits(logits, top_k=None, top_p=0.7))
    assert np.isfinite(out[0, 0]) and np.isfinite(out[0, 1])
    assert out[0, 2] < -1e29 and out[0, 3] < -1e29
    # top_p smaller than the max prob still keeps the argmax
    out = np.asarray(_filter_logits(logits, top_k=None, top_p=0.1))
    assert np.isfinite(out[0, 0])
    assert (out[0, 1:] < -1e29).all()


def test_top_k_one_equals_greedy():
    net, vocab = _llama_net(seed=3)
    prompt = np.array([[1, 2], [5, 6]], np.int64)
    greedy = np.asarray(generate(net, prompt, 5))
    k1 = np.asarray(generate(net, prompt, 5, temperature=1.0,
                             rng=jax.random.PRNGKey(0), top_k=1))
    np.testing.assert_array_equal(greedy, k1)


def test_top_p_tiny_equals_greedy_classic_family():
    """top_p→0 keeps only the argmax — and exercises the filters on the
    classic (build_tiny_lm) family too."""
    from tinynn_autograd_tpu.models import build_tiny_lm

    random_seed(61)
    net = build_tiny_lm(vocab=11, seq_len=10, dim=16, heads=4, depth=1)
    net.init((1, 10))
    prompt = np.array([[1, 2, 3]], np.int64)
    greedy = np.asarray(generate(net, prompt, 4))
    nuc = np.asarray(generate(net, prompt, 4, temperature=1.0,
                              rng=jax.random.PRNGKey(1), top_p=1e-6))
    np.testing.assert_array_equal(greedy, nuc)


# ----------------------------------------------- native GQA flash primitive


def test_gqa_flash_primitive_matches_repeated_kv():
    """flash_attention_ with K/V at Hkv < H heads (native GQA: one kernel
    call per query group, shared K/V) must equal the same primitive on
    manually repeated K/V — values and all three grads (dk/dv summed over
    the group)."""
    b, h, hkv, t, d = 2, 8, 2, 8, 4
    group = h // hkv
    q = _rand(b, h, t, d, seed=20, scale=0.5)
    k = _rand(b, hkv, t, d, seed=21, scale=0.5)
    v = _rand(b, hkv, t, d, seed=22, scale=0.5)
    cot = _rand(b, h, t, d, seed=23, scale=0.1)
    # repeat so query head j reads kv head j // group (the GQA contract)
    krep = np.repeat(k, group, axis=1)
    vrep = np.repeat(v, group, axis=1)

    for causal in (False, True):
        tq, tk, tv = (Tensor(q, requires_grad=True),
                      Tensor(k, requires_grad=True),
                      Tensor(v, requires_grad=True))
        out = ops.flash_attention_(tq, tk, tv, causal=causal)
        out.backward(Tensor(cot))

        rq, rk, rv = (Tensor(q, requires_grad=True),
                      Tensor(krep, requires_grad=True),
                      Tensor(vrep, requires_grad=True))
        ref = ops.flash_attention_(rq, rk, rv, causal=causal)
        ref.backward(Tensor(cot))

        np.testing.assert_allclose(np.asarray(out.data),
                                   np.asarray(ref.data),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(tq.grad), np.asarray(rq.grad),
                                   rtol=1e-4, atol=1e-6)
        want_dk = np.asarray(rk.grad).reshape(b, hkv, group, t, d).sum(2)
        want_dv = np.asarray(rv.grad).reshape(b, hkv, group, t, d).sum(2)
        np.testing.assert_allclose(np.asarray(tk.grad), want_dk,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(tv.grad), want_dv,
                                   rtol=1e-4, atol=1e-6)


def test_gqa_flash_rejects_indivisible_heads():
    q = Tensor(_rand(1, 6, 4, 4))
    kv = Tensor(_rand(1, 4, 4, 4))
    with pytest.raises(ValueError, match="divide"):
        ops.flash_attention_(q, kv, kv)


def test_gqa_flash_dropout_decorrelates_groups():
    """With attention dropout on, each query group folds its index into
    the kernel seed — groups must not share mask streams (a shared stream
    would correlate the zeros across every group of a kv head)."""
    import jax

    b, h, hkv, t, d = 1, 4, 1, 16, 4
    q = _rand(b, h, t, d, seed=30, scale=0.0)  # zero q -> uniform probs
    k = _rand(b, hkv, t, d, seed=31, scale=0.0)
    v = np.ones((b, hkv, t, d), np.float32)
    out = ops.flash_attention_(
        Tensor(q), Tensor(k), Tensor(v), dropout_rate=0.5,
        dropout_rng=jax.random.PRNGKey(3))
    # uniform probs + all-ones V: each output element is the kept-mass
    # of its row's mask; identical group streams would make the head
    # outputs within the kv group exactly equal
    o = np.asarray(out.data).reshape(h, t, d)
    assert not np.allclose(o[0], o[1])
    assert not np.allclose(o[1], o[2])


def test_filter_logits_top_p_zero_keeps_argmax():
    """Regression (round-5 review): top_p <= 0 must keep the max-prob
    token instead of masking everything (which silently degrades to
    uniform-random sampling)."""
    logits = jnp.asarray([[2.0, 1.0, 0.5, -1.0]])
    out = np.asarray(_filter_logits(logits, top_k=None, top_p=0.0))
    assert np.isfinite(out[0, 0])
    assert (out[0, 1:] < -1e29).all()


def test_llama_one_dispatch_epochs_and_remat():
    """The llama net trains through Model.train_epochs (the scanned
    one-dispatch epoch) and the remat-built twin matches it step-for-step (Remat replays the block
    exactly; same init seeds via the reset global stream)."""
    vocab, seq = 8, 10
    rng = np.random.RandomState(0)
    x = ((rng.randint(0, vocab, 32)[:, None] + np.arange(seq)[None, :])
         % vocab)
    y = np.eye(vocab, dtype=np.float32)[(x + 1) % vocab]

    losses = []
    for remat in (False, True):
        random_seed(71)
        net = build_tiny_llama(vocab=vocab, dim=16, heads=4, kv_heads=2,
                               depth=2, remat=remat)
        model = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-2))
        xd, yd = model.stage(x, y)
        out = np.asarray(model.train_epochs(xd, yd, n_epochs=3,
                                            batch_size=8))
        assert np.isfinite(out).all()
        assert out[-1, -1] < out[0, 0]
        losses.append(out)
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5, atol=1e-6)


def test_llama_remat_generate_parity():
    """generate() unwraps Remat for llama nets too."""
    ids = np.random.RandomState(3).randint(0, 9, (2, 4))
    outs = []
    for remat in (False, True):
        random_seed(72)
        net = build_tiny_llama(vocab=9, dim=16, heads=4, kv_heads=1,
                               depth=2, remat=remat)
        net.init((2, 8))
        outs.append(np.asarray(generate(net, ids, 5)))
    np.testing.assert_array_equal(outs[0], outs[1])


# --------------------------------------------------------------- beam search


def _seq_logprob(net, prompt, continuation, pad_to=None):
    """Total log-prob of ``continuation`` after ``prompt`` via full
    forwards (the external scoring oracle for beam search). ``pad_to``:
    fixed input length for nets with a positional table (the zero-padded
    tail is causally invisible to the scored position)."""
    ids = np.asarray(prompt, np.int64).tolist()
    total = 0.0
    for tok in continuation:
        t = len(ids)
        full = ids + [0] * ((pad_to or t) - t)
        logits = np.asarray(
            net.forward(Tensor(np.asarray([full], np.int64))).data)[0, t - 1]
        logz = np.log(np.exp(logits - logits.max()).sum()) + logits.max()
        total += float(logits[tok] - logz)
        ids.append(int(tok))
    return total


@pytest.mark.parametrize("family", ["llama", "classic"])
def test_beam_exhaustive_finds_global_argmax(family):
    """With beam_width == vocab and n_new == 2 the search is EXHAUSTIVE
    (all V first tokens kept, joint top over V*V continuations) — it must
    return the brute-force argmax sequence in both families."""
    from itertools import product

    from tinynn_autograd_tpu.models import build_tiny_lm, generate_beam

    vocab = 5
    random_seed(91)
    if family == "llama":
        net = build_tiny_llama(vocab=vocab, dim=16, heads=4, kv_heads=2,
                               depth=1)
        net.init((1, 4))
    else:
        net = build_tiny_lm(vocab=vocab, seq_len=6, dim=16, heads=4,
                            depth=1)
        net.init((1, 6))
    prompt = np.array([[2, 0]], np.int64)
    out = np.asarray(generate_beam(net, prompt, n_new=2,
                                   beam_width=vocab))
    want, best = None, -np.inf
    for cont in product(range(vocab), repeat=2):
        s = _seq_logprob(net, prompt[0], cont,
                         pad_to=6 if family == "classic" else None)
        if s > best:
            best, want = s, cont
    np.testing.assert_array_equal(out[0, 2:], np.asarray(want))


def test_beam_width_one_equals_greedy():
    from tinynn_autograd_tpu.models import generate_beam

    random_seed(92)
    net = build_tiny_llama(vocab=9, dim=16, heads=4, kv_heads=1, depth=2)
    net.init((2, 6))
    prompt = np.array([[1, 2, 3], [4, 5, 6]], np.int64)
    greedy = np.asarray(generate(net, prompt, 5))
    beam1 = np.asarray(generate_beam(net, prompt, 5, beam_width=1))
    np.testing.assert_array_equal(greedy, beam1)


def test_beam_guards():
    from tinynn_autograd_tpu.models import generate_beam

    random_seed(93)
    net = build_tiny_llama(vocab=5, dim=16, heads=4, depth=1)
    net.init((1, 4))
    with pytest.raises(ValueError, match="beam_width"):
        generate_beam(net, np.zeros((1, 2), np.int64), 2, beam_width=0)
    with pytest.raises(ValueError, match="vocab"):
        generate_beam(net, np.zeros((1, 2), np.int64), 2, beam_width=6)


def test_beam_follows_trained_grammar():
    vocab, seq = 8, 10
    random_seed(94)
    net = build_tiny_llama(vocab=vocab, dim=32, heads=4, kv_heads=2,
                           depth=1)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-2))
    rng = np.random.RandomState(0)
    starts = rng.randint(0, vocab, 64)
    x = (starts[:, None] + np.arange(seq)[None, :]) % vocab
    y = np.eye(vocab, dtype=np.float32)[(x + 1) % vocab]
    for _ in range(80):
        model.train_step(x, y)
    from tinynn_autograd_tpu.models import generate_beam

    prompt = np.array([[3, 4, 5], [0, 1, 2]], np.int64)
    out = np.asarray(generate_beam(net, prompt, 4, beam_width=3))
    want = np.array([[3, 4, 5, 6, 7, 0, 1], [0, 1, 2, 3, 4, 5, 6]])
    np.testing.assert_array_equal(out, want)


def test_generate_eos_freezes_finished_rows():
    """After a row emits eos_id, every later position repeats it; rows
    that never emit it are unaffected (parity with the eos-free call)."""
    vocab, seq = 8, 10
    random_seed(95)
    net = build_tiny_llama(vocab=vocab, dim=32, heads=4, kv_heads=2,
                           depth=1)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-2))
    rng = np.random.RandomState(0)
    starts = rng.randint(0, vocab, 64)
    x = (starts[:, None] + np.arange(seq)[None, :]) % vocab
    y = np.eye(vocab, dtype=np.float32)[(x + 1) % vocab]
    for _ in range(80):
        model.train_step(x, y)
    # grammar: next = cur + 1 mod 8. Row 0 starts at 3 -> emits 4,5,6...
    prompt = np.array([[2, 3], [5, 6]], np.int64)
    out = np.asarray(generate(net, prompt, 5, eos_id=5))
    # row 0 emits 4 then 5 (eos) -> frozen at 5
    np.testing.assert_array_equal(out[0], [2, 3, 4, 5, 5, 5, 5])
    # row 1 emits 7, 0, 1, 2, 3 — never 5 — identical to the no-eos call
    plain = np.asarray(generate(net, prompt, 5))
    np.testing.assert_array_equal(out[1], plain[1])


def test_beam_eos_freezes_finished_beams():
    """A beam that emits eos_id freezes: its score stops accumulating and
    its tail fills with eos; the returned best row for a grammar that
    hits eos immediately is all-eos after the hit."""
    from tinynn_autograd_tpu.models import generate_beam

    vocab, seq = 8, 10
    random_seed(96)
    net = build_tiny_llama(vocab=vocab, dim=32, heads=4, kv_heads=2,
                           depth=1)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-2))
    rng = np.random.RandomState(0)
    starts = rng.randint(0, vocab, 64)
    x = (starts[:, None] + np.arange(seq)[None, :]) % vocab
    y = np.eye(vocab, dtype=np.float32)[(x + 1) % vocab]
    for _ in range(80):
        model.train_step(x, y)
    prompt = np.array([[2, 3], [5, 6]], np.int64)
    out = np.asarray(generate_beam(net, prompt, 5, beam_width=3, eos_id=5))
    np.testing.assert_array_equal(out[0], [2, 3, 4, 5, 5, 5, 5])
    plain = np.asarray(generate_beam(net, prompt, 5, beam_width=3))
    np.testing.assert_array_equal(out[1], plain[1])


def test_generate_compiled_program_is_cached():
    """Repeated generate() calls with the same net shape reuse ONE
    compiled program (the per-call @jax.jit closure recompiled every
    invocation — review finding); training further and regenerating also
    reuses it (params are call-time args)."""
    from tinynn_autograd_tpu.models import generate as gen_mod
    from tinynn_autograd_tpu.models.generate import _decode_fn

    _decode_fn.cache_clear()
    random_seed(111)
    net = build_tiny_llama(vocab=9, dim=16, heads=4, kv_heads=2, depth=1)
    net.init((2, 4))
    prompt = np.array([[1, 2], [3, 4]], np.int64)
    generate(net, prompt, 3)
    info1 = _decode_fn.cache_info()
    generate(net, prompt, 3)
    info2 = _decode_fn.cache_info()
    assert info2.hits == info1.hits + 1
    # mutate params (as further training would) — same cached program
    for kname, t in net.layers[1].params.items():
        net.layers[1].params[kname] = type(t)(
            np.asarray(t.data) * 1.01, requires_grad=True)
    out = generate(net, prompt, 3)
    assert _decode_fn.cache_info().hits == info2.hits + 1
    assert out.shape == (2, 5)


def test_generate_heterogeneous_per_block_windows():
    """Blocks with DIFFERENT attn_window values (interleaved local/global
    attention) must decode token-for-token with the full forward — the
    pre-fix extractor kept only the LAST block's window."""
    from tinynn_autograd_tpu.nn.layers import (
        Dense, Embedding, LlamaBlock, RMSNorm,
    )
    from tinynn_autograd_tpu.nn.net import Net

    random_seed(112)
    net = Net([Embedding(11, 16),
               LlamaBlock(16, 4, num_kv_heads=2, attn_window=3),
               LlamaBlock(16, 4, num_kv_heads=2, attn_window=None),
               RMSNorm(16), Dense(11, num_in=16)])
    net.init((2, 6))
    rng = np.random.RandomState(2)
    prompt = rng.randint(0, 11, (2, 5))
    out = np.asarray(generate(net, prompt, 6))
    ids = prompt.copy()
    for _ in range(6):
        logits = net.forward(Tensor(jnp.asarray(ids))).data
        nxt = np.asarray(jnp.argmax(logits[:, -1], axis=-1))
        ids = np.concatenate([ids, nxt[:, None].astype(ids.dtype)], axis=1)
    np.testing.assert_array_equal(out, ids)


def test_generate_rejects_mixed_block_meta():
    """Per-block heterogeneity is supported ONLY for attn_window; mixed
    rope_base (or heads/eps) would silently decode with the last block's
    meta — reject instead."""
    from tinynn_autograd_tpu.nn.layers import (
        Dense, Embedding, LlamaBlock, RMSNorm,
    )
    from tinynn_autograd_tpu.nn.net import Net

    random_seed(113)
    net = Net([Embedding(9, 16),
               LlamaBlock(16, 4, num_kv_heads=2, rope_base=10000.0),
               LlamaBlock(16, 4, num_kv_heads=2, rope_base=1e6),
               RMSNorm(16), Dense(9, num_in=16)])
    net.init((1, 4))
    with pytest.raises(ValueError, match="UNIFORM"):
        generate(net, np.zeros((1, 2), np.int64), 2)


# --------------------------------------------------------------------- ViT


def test_reshape_layer_values_grads_and_guards():
    from tinynn_autograd_tpu.nn.layers import Reshape

    x = _rand(2, 3, 4, seed=40)
    lyr = Reshape((-1,))
    out = lyr.forward(Tensor(x, requires_grad=True))
    assert out.shape == (2, 12)
    assert lyr.init_params((2, 3, 4)) == (2, 12)
    lyr2 = Reshape((2, 2, 3))
    assert lyr2.init_params((5, 3, 4)) == (5, 2, 2, 3)
    with pytest.raises(ValueError, match="-1"):
        Reshape((-1, -1))
    # grads restore the input shape through the tape
    t = Tensor(x, requires_grad=True)
    out = Reshape((4, 3)).forward(t)
    out.backward(Tensor(np.ones((2, 4, 3), np.float32)))
    assert np.asarray(t.grad).shape == x.shape


def test_tiny_vit_learns_quadrant_task():
    """ViT by composition (Conv2D patchify + Reshape + blocks): classify
    which image quadrant carries the bright patch — position embeddings +
    attention must route it."""
    from tinynn_autograd_tpu.models import build_tiny_vit

    rng = np.random.RandomState(0)
    n, hw = 128, 8
    labels = rng.randint(0, 4, n)
    x = rng.randn(n, hw, hw, 1).astype(np.float32) * 0.1
    for i, q in enumerate(labels):
        r, c = divmod(int(q), 2)
        x[i, r * 4:(r + 1) * 4, c * 4:(c + 1) * 4, 0] += 2.0
    y = np.eye(4, dtype=np.float32)[labels]

    random_seed(121)
    net = build_tiny_vit(image_shape=(hw, hw, 1), patch=4, dim=32,
                         heads=4, depth=1, num_out=4)
    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(3e-3))
    first = last = None
    for i in range(60):
        loss = float(model.train_step(x, y))
        first = loss if i == 0 else first
        last = loss
    assert last < first * 0.1, (first, last)
    pred = np.asarray(model.forward(Tensor(x)).data).argmax(-1)
    assert (pred == labels).mean() > 0.95
