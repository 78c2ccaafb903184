"""Per-config benchmark sweep (bench.py stays the single-line headline).
Prints one JSON line per config.

Methodology:
- every timing is closed by ``jax.block_until_ready`` on the run's output
  and covers a whole multi-epoch run dispatched as ONE device call; the
  compile happens in a same-shape warmup outside the timed window;
- every config runs REPEATS times; the line reports the MEDIAN and the
  relative spread (max-min)/median;
- every line names the device it ran on (platform, device_kind,
  device_count, the card's name and power limit); the sweep refuses to
  run without a GPU;
- the transformer, llama, CNN and LSTM configs also time a hand-written
  jax.grad oracle of the identical model in the same run (external oracle
  only — the framework itself never uses jax.grad).
"""

import json
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, ".")

BASELINE = 45.9  # reference MNIST MLP steps/s (BASELINE.md)
REPEATS = 3
DEVICE = {}   # filled by main() from utils.device.require_gpu()


def _run_epochs(model, x_dev, y_dev, batch, n_epochs):
    import jax

    return jax.block_until_ready(model.train_epochs(
        x_dev, y_dev, n_epochs=n_epochs, batch_size=batch))


def _time_epochs(model, x_dev, y_dev, batch, n_epochs, steps_per_epoch):
    """Median steps/s over REPEATS runs (one dispatch each), after a
    same-shape warmup that compiles the program."""
    _run_epochs(model, x_dev, y_dev, batch, n_epochs)  # warmup/compile
    rates = []
    for _ in range(REPEATS):
        start = time.perf_counter()
        _run_epochs(model, x_dev, y_dev, batch, n_epochs)
        rates.append(n_epochs * steps_per_epoch
                     / (time.perf_counter() - start))
    return rates


def emit(metric, rates, unit="steps/s", vs=None):
    med = statistics.median(rates)
    rec = {"metric": metric, "value": med, "unit": unit,
           "repeats": len(rates)}
    if len(rates) > 1:
        rec["spread_pct"] = 100 * (max(rates) - min(rates)) / med
    if vs is not None:
        rec["vs_baseline"] = med / vs
    rec.update(DEVICE)
    print(json.dumps(rec), flush=True)
    return med


def _adam_tree(lr):
    import jax
    import jax.numpy as jnp

    b1, b2, eps = 0.9, 0.999, 1e-8

    def adam(p, slots, t, g):
        m = jax.tree.map(lambda mm, gg: mm + (1 - b1) * (gg - mm),
                         slots["m"], g)
        v = jax.tree.map(lambda vv, gg: vv + (1 - b2) * (gg * gg - vv),
                         slots["v"], g)
        tf = t.astype(jnp.float32)
        mh = jax.tree.map(lambda mm: mm / (1 - jnp.exp(tf * np.log(b1))), m)
        vh = jax.tree.map(lambda vv: vv / (1 - jnp.exp(tf * np.log(b2))), v)
        new_p = jax.tree.map(
            lambda pp, mm, vv: pp - lr * mm / (jnp.sqrt(vv) + eps),
            p, mh, vh)
        return new_p, {"m": m, "v": v}

    return adam


def _oracle_run_rates(params, loss_fn, x_all, y_all, batch, n_epochs, lr,
                      stochastic=False):
    """Shared oracle runner: jax.grad step + Adam, same on-device shuffle /
    scan / one-dispatch amortization as Model.train_epochs. With
    ``stochastic=True``, loss_fn takes a per-step PRNG key (dropout
    oracles) folded from the step counter, mirroring the framework."""
    import jax
    import jax.numpy as jnp

    adam = _adam_tree(lr)
    n = x_all.shape[0]
    n_steps = n // batch
    drop_base = jax.random.PRNGKey(17)

    def runner(p, slots, t, xs, ys, rng):
        def epoch(carry, ekey):
            p, slots, t = carry
            perm = jax.random.permutation(ekey, n)[: n_steps * batch]
            xb = xs[perm].reshape((n_steps, batch) + xs.shape[1:])
            yb = ys[perm].reshape((n_steps, batch) + ys.shape[1:])

            def body(carry, b):
                p, slots, t = carry
                if stochastic:
                    skey = jax.random.fold_in(drop_base, t)
                    l, g = jax.value_and_grad(loss_fn)(p, b[0], b[1], skey)
                else:
                    l, g = jax.value_and_grad(loss_fn)(p, b[0], b[1])
                t = t + 1
                p, slots = adam(p, slots, t, g)
                return (p, slots, t), l

            (p, slots, t), losses = jax.lax.scan(body, (p, slots, t),
                                                 (xb, yb))
            return (p, slots, t), losses

        keys = jax.random.split(rng, n_epochs)
        (p, slots, t), losses = jax.lax.scan(epoch, (p, slots, t), keys)
        return p, slots, t, losses

    jit_run = jax.jit(runner, donate_argnums=(0, 1, 2))
    slots = {"m": jax.tree.map(jnp.zeros_like, params),
             "v": jax.tree.map(jnp.zeros_like, params)}
    t0 = jnp.zeros((), jnp.int32)
    rng = jax.random.PRNGKey(0)
    x_dev = jax.device_put(x_all)
    y_dev = jax.device_put(y_all)

    p, s, t, losses = jax.block_until_ready(
        jit_run(params, slots, t0, x_dev, y_dev, rng))   # warmup/compile
    rates = []
    for _ in range(REPEATS):
        start = time.perf_counter()
        p, s, t, losses = jax.block_until_ready(
            jit_run(p, s, t, x_dev, y_dev, rng))
        rates.append(n_epochs * n_steps / (time.perf_counter() - start))
    return rates


def _cnn_oracle_rates(net, x_all, y_all, batch, n_epochs, lr):
    """EXTERNAL oracle for the CNN config: hand-written pure-JAX
    (jax.grad + lax.conv/reduce_window) training step of the SAME model,
    weights copied from the net, same one-dispatch run length."""
    import jax
    import jax.numpy as jnp

    from tinynn_autograd_tpu.nn.layers import Conv2D, Dense

    convs = [l for l in net.layers if isinstance(l, Conv2D)]
    denses = [l for l in net.layers if isinstance(l, Dense)]
    params = {
        "c": [{k: v.data for k, v in l.params.items()} for l in convs],
        "d": [{k: v.data for k, v in l.params.items()} for l in denses],
    }

    def fwd(p, x):
        h = x
        for cp in p["c"]:
            h = jax.lax.conv_general_dilated(
                h, cp["w"], window_strides=(1, 1), padding="SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC")) + cp["b"]
            h = jnp.maximum(h, 0.0)
            h = jax.lax.reduce_window(
                h, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1),
                "VALID")
        h = h.reshape(h.shape[0], -1)
        h = jnp.maximum(h @ p["d"][0]["w"] + p["d"][0]["b"], 0.0)
        return h @ p["d"][1]["w"] + p["d"][1]["b"]

    def loss_fn(p, x, y):
        logits = fwd(p, x)
        logz = jax.nn.logsumexp(logits, axis=-1, keepdims=True)
        return -((logits - logz) * y).sum(-1).mean()

    return _oracle_run_rates(params, loss_fn, x_all, y_all, batch,
                             n_epochs, lr)


def _transformer_oracle_rates(net, x_all, y_all, batch, n_epochs, lr,
                              dropout=0.0, attn_dropout=0.0, window=None):
    """EXTERNAL oracle for the transformer config: a hand-written
    pure-JAX (jax.grad) training step of the SAME model — weights copied
    from the net, same shuffle/scan/one-dispatch run, same Adam rule. The
    framework itself never uses jax.grad; this is what plain XLA makes of
    the same model.
    ``dropout``/``attn_dropout``: standard jax.random.bernoulli masks at
    the same sites/rates as TransformerBlock (different mask streams, same
    distribution and FLOPs — the fair dropout-regime oracle)."""
    import jax
    import jax.numpy as jnp

    from tinynn_autograd_tpu.nn.layers import (
        Dense, Embedding, GlobalAvgPool1D, PositionalEmbedding,
        TransformerBlock,
    )

    # flatten the net's concrete params into a plain dict pytree
    blocks = []
    emb = pos = head = None
    heads = None
    for layer in net.layers:
        if isinstance(layer, Embedding):
            emb = layer.params["w"].data
        elif isinstance(layer, PositionalEmbedding):
            pos = layer.params["pos"].data
        elif isinstance(layer, TransformerBlock):
            heads = layer.num_heads
            blocks.append({k: v.data for k, v in layer.params.items()})
        elif isinstance(layer, Dense):
            head = {k: v.data for k, v in layer.params.items()}
        elif isinstance(layer, GlobalAvgPool1D):
            pass
    params = {"emb": emb, "pos": pos, "blocks": blocks, "head": head}

    c = np.sqrt(2.0 / np.pi).astype(np.float32)

    def gelu(x):
        return 0.5 * x * (1.0 + jnp.tanh(c * (x + 0.044715 * x ** 3)))

    def ln(x, g, b, eps=1e-5):
        mu = x.mean(-1, keepdims=True)
        var = ((x - mu) ** 2).mean(-1, keepdims=True)
        return (x - mu) / jnp.sqrt(var + eps) * g + b

    causal = any(getattr(l, "causal", False)
                 for l in net.layers
                 if isinstance(l, TransformerBlock))
    stochastic = dropout > 0.0 or attn_dropout > 0.0

    def fwd(p, ids, key=None):
        h = p["emb"][ids] + p["pos"]
        bsz, t, d = h.shape
        hd = d // heads

        def drop(x, rate, k):
            keep = jax.random.bernoulli(k, 1.0 - rate, x.shape)
            return jnp.where(keep, x / (1.0 - rate), 0.0)

        for bi, bp in enumerate(p["blocks"]):
            if stochastic:
                k0, k1, k2 = jax.random.split(
                    jax.random.fold_in(key, bi), 3)
            xn = ln(h, bp["g1"], bp["be1"])
            def sh(x):
                return x.reshape(bsz, t, heads, hd).transpose(0, 2, 1, 3)
            q, k, v = sh(xn @ bp["wq"]), sh(xn @ bp["wk"]), sh(xn @ bp["wv"])
            s = (q @ k.transpose(0, 1, 3, 2)) / np.sqrt(hd)
            if causal:
                m = np.tril(np.ones((t, t), np.bool_))
                if window is not None:
                    m &= ~np.tril(np.ones((t, t), np.bool_), -window)
                s = s + jnp.where(jnp.asarray(m), 0.0, -1e9)
            att = jax.nn.softmax(s, axis=-1)
            if attn_dropout > 0.0:
                att = drop(att, attn_dropout, k0)
            ctx = (att @ v).transpose(0, 2, 1, 3).reshape(bsz, t, d)
            attn_out = ctx @ bp["wo"]
            if dropout > 0.0:
                attn_out = drop(attn_out, dropout, k1)
            h = h + attn_out
            yn = ln(h, bp["g2"], bp["be2"])
            mlp = gelu(yn @ bp["w1"] + bp["b1"]) @ bp["w2"] + bp["b2"]
            if dropout > 0.0:
                mlp = drop(mlp, dropout, k2)
            h = h + mlp
        pooled = h.mean(axis=1)
        return pooled @ p["head"]["w"] + p["head"]["b"]

    def loss_fn(p, ids, y, key=None):
        logits = fwd(p, ids, key)
        logz = jax.nn.logsumexp(logits, axis=-1, keepdims=True)
        return -((logits - logz) * y).sum(-1).mean()

    return _oracle_run_rates(params, loss_fn, x_all, y_all, batch,
                             n_epochs, lr, stochastic=stochastic)


def bench_transformer():
    """Config 6: transformer seq-classifier through the scanned
    one-dispatch epoch, with a hand-written jax.grad oracle of the
    identical model timed in the same run."""
    from tinynn_autograd_tpu.models import build_tiny_transformer
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn import optimizer as opt
    from tinynn_autograd_tpu.utils.datasets import one_hot
    from tinynn_autograd_tpu.utils.seeder import random_seed

    vocab, seq, dim, heads, depth, nout = 256, 128, 256, 8, 4, 16
    batch, n_epochs, n_train = 32, 8, 2048
    rng = np.random.RandomState(0)
    tx = rng.randint(0, vocab, (n_train, seq))
    ty = one_hot(rng.randint(0, nout, n_train), nout)

    random_seed(0)
    net = build_tiny_transformer(vocab=vocab, seq_len=seq, dim=dim,
                                 heads=heads, depth=depth, num_out=nout)
    m = Model(net, SoftmaxCrossEntropyLoss(), opt.Adam(1e-3))
    x_dev, y_dev = m.stage(tx, ty)
    rates = _time_epochs(m, x_dev, y_dev, batch, n_epochs, n_train // batch)

    oracle_rates = _transformer_oracle_rates(net, tx, ty, batch, n_epochs,
                                             lr=1e-3)
    emit("transformer_cls_train_steps_per_sec", rates)
    emit("transformer_cls_jaxgrad_oracle_steps_per_sec", oracle_rates)


def bench_transformer_long():
    """Config 6b: LONG-context CAUSAL transformer (seq 2048, head_dim 64)
    — where the flash-attention kernels engage (ops/attention.py
    auto-dispatch): the oracle's XLA attention materializes [T, T] scores
    in device memory, the kernels keep them in on-chip tiles and skip the
    fully-masked causal tiles. Same-run jax.grad oracle of the identical
    (causal) model."""
    from tinynn_autograd_tpu.models import build_tiny_transformer
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn import optimizer as opt
    from tinynn_autograd_tpu.utils.datasets import one_hot
    from tinynn_autograd_tpu.utils.seeder import random_seed

    vocab, seq, dim, heads, depth, nout = 256, 2048, 512, 8, 2, 16
    batch, n_epochs, n_train = 4, 4, 256
    rng = np.random.RandomState(0)
    tx = rng.randint(0, vocab, (n_train, seq))
    ty = one_hot(rng.randint(0, nout, n_train), nout)

    random_seed(0)
    net = build_tiny_transformer(vocab=vocab, seq_len=seq, dim=dim,
                                 heads=heads, depth=depth, num_out=nout,
                                 causal=True)
    m = Model(net, SoftmaxCrossEntropyLoss(), opt.Adam(1e-3))
    x_dev, y_dev = m.stage(tx, ty)
    rates = _time_epochs(m, x_dev, y_dev, batch, n_epochs, n_train // batch)

    oracle_rates = _transformer_oracle_rates(net, tx, ty, batch, n_epochs,
                                             lr=1e-3)
    emit("transformer_seq2048_causal_train_steps_per_sec", rates)
    emit("transformer_seq2048_causal_jaxgrad_oracle_steps_per_sec",
         oracle_rates)


def bench_transformer_long_dropout():
    """Config 6c: config 6b WITH dropout — residual 0.1 +
    attention-probability 0.1 — against a jax.grad oracle running standard
    bernoulli-mask dropout at the same sites/rates. The framework's
    attention dropout is the in-kernel hash-mask replay inside the flash
    kernels (no [T, T] mask or score tensors); the oracle materializes
    both."""
    from tinynn_autograd_tpu.models import build_tiny_transformer
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn import optimizer as opt
    from tinynn_autograd_tpu.utils.datasets import one_hot
    from tinynn_autograd_tpu.utils.seeder import random_seed

    vocab, seq, dim, heads, depth, nout = 256, 2048, 512, 8, 2, 16
    batch, n_epochs, n_train = 4, 4, 256
    rng = np.random.RandomState(0)
    tx = rng.randint(0, vocab, (n_train, seq))
    ty = one_hot(rng.randint(0, nout, n_train), nout)

    random_seed(0)
    net = build_tiny_transformer(vocab=vocab, seq_len=seq, dim=dim,
                                 heads=heads, depth=depth, num_out=nout,
                                 causal=True, dropout=0.1,
                                 attn_dropout=0.1)
    m = Model(net, SoftmaxCrossEntropyLoss(), opt.Adam(1e-3))
    x_dev, y_dev = m.stage(tx, ty)
    rates = _time_epochs(m, x_dev, y_dev, batch, n_epochs, n_train // batch)

    oracle_rates = _transformer_oracle_rates(net, tx, ty, batch, n_epochs,
                                             lr=1e-3, dropout=0.1,
                                             attn_dropout=0.1)
    emit("transformer_seq2048_causal_dropout_train_steps_per_sec", rates)
    emit("transformer_seq2048_causal_dropout_jaxgrad_oracle_steps_per_sec",
         oracle_rates)


def _llama_oracle_rates(net, x_all, y_all, batch, n_epochs, lr):
    """EXTERNAL oracle for the llama config: hand-written pure-JAX
    (jax.grad) training step of the SAME model — RMSNorm, RoPE, GQA (kv
    repeated with jnp.repeat — the standard XLA formulation), SwiGLU,
    standard materialized-score attention. Weights copied from the net,
    same shuffle/scan/one-dispatch run, same Adam rule."""
    return _oracle_run_rates(*llama_oracle(net), x_all, y_all, batch,
                             n_epochs, lr)


def llama_oracle(net):
    """(params, loss_fn) of a plain jax.numpy twin of a build_tiny_llama
    net: the params copied from the net, loss_fn(params, ids, onehot) the
    summed-over-positions softmax cross-entropy the framework's loss
    computes. chip_smoke.py differentiates it with jax.grad as the
    reference for the tape."""
    import jax
    import jax.numpy as jnp

    from tinynn_autograd_tpu.nn.layers import Dense, Embedding, LlamaBlock
    from tinynn_autograd_tpu.nn.layers import RMSNorm as RMSNormLayer

    blocks, emb, head, norm = [], None, None, None
    h = hkv = hd = eps = base = None
    for layer in net.layers:
        if isinstance(layer, Embedding):
            emb = layer.params["w"].data
        elif isinstance(layer, LlamaBlock):
            h, hkv, hd = (layer.num_heads, layer.num_kv_heads,
                          layer.head_dim)
            eps, base = layer.eps, layer.rope_base
            blocks.append({k: v.data for k, v in layer.params.items()})
        elif isinstance(layer, RMSNormLayer):
            norm = layer.params["g"].data
        elif isinstance(layer, Dense):
            head = {k: v.data for k, v in layer.params.items()}
    params = {"emb": emb, "blocks": blocks, "norm": norm, "head": head}

    def rms(x, g):
        return x * jax.lax.rsqrt((x * x).mean(-1, keepdims=True) + eps) * g

    def rope(x):
        t, d = x.shape[-2], x.shape[-1]
        half = d // 2
        inv = base ** (-jnp.arange(half, dtype=jnp.float32) / half)
        ang = jnp.arange(t, dtype=jnp.float32)[:, None] * inv[None, :]
        cos, sin = jnp.cos(ang), jnp.sin(ang)
        x1, x2 = x[..., :half], x[..., half:]
        return jnp.concatenate([x1 * cos - x2 * sin,
                                x2 * cos + x1 * sin], -1)

    def fwd(p, ids):
        x = p["emb"][ids]
        bsz, t, d = x.shape
        mask = jnp.asarray(np.tril(np.ones((t, t), np.float32))) == 1.0
        for bp in p["blocks"]:
            xn = rms(x, bp["g1"])
            q = (xn @ bp["wq"]).reshape(bsz, t, h, hd).transpose(0, 2, 1, 3)
            k = (xn @ bp["wk"]).reshape(bsz, t, hkv, hd).transpose(
                0, 2, 1, 3)
            v = (xn @ bp["wv"]).reshape(bsz, t, hkv, hd).transpose(
                0, 2, 1, 3)
            q, k = rope(q), rope(k)
            if hkv != h:
                k = jnp.repeat(k, h // hkv, axis=1)
                v = jnp.repeat(v, h // hkv, axis=1)
            s = (q @ k.transpose(0, 1, 3, 2)) / np.sqrt(hd)
            s = jnp.where(mask, s, -1e30)
            att = jax.nn.softmax(s, axis=-1)
            ctx = (att @ v).transpose(0, 2, 1, 3).reshape(bsz, t, d)
            x = x + ctx @ bp["wo"]
            yn = rms(x, bp["g2"])
            x = x + (jax.nn.silu(yn @ bp["w1"]) * (yn @ bp["w3"])) \
                @ bp["w2"]
        return rms(x, p["norm"]) @ p["head"]["w"] + p["head"]["b"]

    def loss_fn(p, ids, y):
        logits = fwd(p, ids)
        logz = jax.nn.logsumexp(logits, axis=-1, keepdims=True)
        return -((logits - logz) * y).sum(-1).sum(-1).mean()

    return params, loss_fn


def bench_llama():
    """Config 9: the modern-LLM family — causal llama LM (RMSNorm + RoPE
    + GQA 8q/2kv + SwiGLU) at seq 1024 next-token training through the
    scanned one-dispatch epoch, vs a same-run jax.grad oracle of the
    identical model whose XLA attention materializes [T, T] scores and
    the repeated GQA K/V."""
    from tinynn_autograd_tpu.models import build_tiny_llama
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn import optimizer as opt
    from tinynn_autograd_tpu.utils.seeder import random_seed

    vocab, seq, dim, heads, kv_heads, depth = 256, 1024, 512, 8, 2, 2
    batch, n_epochs, n_train = 4, 16, 64
    rng = np.random.RandomState(0)
    tx = rng.randint(0, vocab, (n_train, seq))
    ty = np.eye(vocab, dtype=np.float32)[
        np.roll(tx, -1, axis=1)]  # next-token targets

    random_seed(0)
    net = build_tiny_llama(vocab=vocab, dim=dim, heads=heads,
                           kv_heads=kv_heads, depth=depth)
    m = Model(net, SoftmaxCrossEntropyLoss(), opt.Adam(1e-3))
    x_dev, y_dev = m.stage(tx, ty)
    rates = _time_epochs(m, x_dev, y_dev, batch, n_epochs, n_train // batch)

    oracle_rates = _llama_oracle_rates(net, tx, ty, batch, n_epochs,
                                       lr=1e-3)
    emit("llama_seq1024_gqa_train_steps_per_sec", rates)
    emit("llama_seq1024_gqa_jaxgrad_oracle_steps_per_sec", oracle_rates)


def bench_transformer_long_window():
    """Config 6d: config 6b WITH sliding-window attention (window 512
    over seq 2048) — the flash kernels visit only the in-band tiles
    (O(T*window)), while the jax.grad oracle computes the full [T, T]
    scores and masks the band. Same-run oracle of the identical (banded)
    function."""
    from tinynn_autograd_tpu.models import build_tiny_transformer
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn import optimizer as opt
    from tinynn_autograd_tpu.utils.datasets import one_hot
    from tinynn_autograd_tpu.utils.seeder import random_seed

    vocab, seq, dim, heads, depth, nout = 256, 2048, 512, 8, 2, 16
    window = 512
    batch, n_epochs, n_train = 4, 4, 256
    rng = np.random.RandomState(0)
    tx = rng.randint(0, vocab, (n_train, seq))
    ty = one_hot(rng.randint(0, nout, n_train), nout)

    random_seed(0)
    net = build_tiny_transformer(vocab=vocab, seq_len=seq, dim=dim,
                                 heads=heads, depth=depth, num_out=nout,
                                 causal=True, attn_window=window)
    m = Model(net, SoftmaxCrossEntropyLoss(), opt.Adam(1e-3))
    x_dev, y_dev = m.stage(tx, ty)
    rates = _time_epochs(m, x_dev, y_dev, batch, n_epochs, n_train // batch)

    oracle_rates = _transformer_oracle_rates(net, tx, ty, batch, n_epochs,
                                             lr=1e-3, window=window)
    emit("transformer_seq2048_window512_train_steps_per_sec", rates)
    emit("transformer_seq2048_window512_jaxgrad_oracle_steps_per_sec",
         oracle_rates)


def _rnn_oracle_rates(net, x_all, y_all, batch, n_epochs, lr):
    """EXTERNAL oracle for the recurrent config: a hand-written pure-JAX
    (jax.grad through lax.scan) training step of the SAME stacked LSTM
    classifier — weights copied from the net, same shuffle/scan/
    one-dispatch run, same Adam rule (the framework's backward is the
    hand-written reverse scan; the oracle's is jax.grad's transpose of
    the forward scan — identical dependency structure)."""
    import jax
    import jax.numpy as jnp

    from tinynn_autograd_tpu.nn.layers import LSTM, Dense

    cells, head = [], None
    for layer in net.layers:
        if isinstance(layer, LSTM):
            cells.append({k: v.data for k, v in layer.params.items()})
        elif isinstance(layer, Dense):
            head = {k: v.data for k, v in layer.params.items()}
    params = {"cells": cells, "head": head}

    def lstm_seq(x, lp):
        hdim = lp["wh"].shape[0]
        bsz = x.shape[0]

        def body(carry, x_t):
            h, c = carry
            z = x_t @ lp["wx"] + h @ lp["wh"] + lp["b"]
            i = jax.nn.sigmoid(z[:, :hdim])
            f = jax.nn.sigmoid(z[:, hdim:2 * hdim])
            g = jnp.tanh(z[:, 2 * hdim:3 * hdim])
            o = jax.nn.sigmoid(z[:, 3 * hdim:])
            c = f * c + i * g
            h = o * jnp.tanh(c)
            return (h, c), h

        z0 = jnp.zeros((bsz, hdim), x.dtype)
        (h_last, _), hs = jax.lax.scan(body, (z0, z0),
                                       jnp.swapaxes(x, 0, 1))
        return jnp.swapaxes(hs, 0, 1), h_last

    def loss_fn(p, x, y):
        h = x
        for lp in p["cells"][:-1]:
            h, _ = lstm_seq(h, lp)
        _, h_last = lstm_seq(h, p["cells"][-1])
        logits = h_last @ p["head"]["w"] + p["head"]["b"]
        logz = jax.nn.logsumexp(logits, axis=-1, keepdims=True)
        return -((logits - logz) * y).sum(-1).mean()

    return _oracle_run_rates(params, loss_fn, x_all, y_all, batch,
                             n_epochs, lr)


def bench_rnn():
    """Config 8: stacked-LSTM sequence classifier (2x256 over T=128 D=64)
    through the scanned one-dispatch epoch, vs a same-run jax.grad oracle
    of the identical model. The recurrence is latency-bound (dependent
    matmuls per time step, serial over T); both sides run the same scan
    structure."""
    from tinynn_autograd_tpu.models import build_rnn_classifier
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn import optimizer as opt
    from tinynn_autograd_tpu.utils.datasets import one_hot
    from tinynn_autograd_tpu.utils.seeder import random_seed

    t, d, hdim, nout = 128, 64, 256, 16
    batch, n_epochs, n_train = 64, 12, 2048
    rng = np.random.RandomState(0)
    tx = rng.randn(n_train, t, d).astype(np.float32)
    ty = one_hot(rng.randint(0, nout, n_train), nout)

    random_seed(0)
    net = build_rnn_classifier(num_in=d, num_out=nout, hidden=(hdim, hdim),
                               cell="lstm", seed=77)
    m = Model(net, SoftmaxCrossEntropyLoss(), opt.Adam(1e-3))
    x_dev, y_dev = m.stage(tx, ty)
    rates = _time_epochs(m, x_dev, y_dev, batch, n_epochs, n_train // batch)

    oracle_rates = _rnn_oracle_rates(net, tx, ty, batch, n_epochs, lr=1e-3)
    emit("lstm_stacked_cls_train_steps_per_sec", rates)
    emit("lstm_stacked_cls_jaxgrad_oracle_steps_per_sec", oracle_rates)


def main():
    import jax

    from tinynn_autograd_tpu.models import (
        build_deep_mlp, build_mnist_cnn, build_mnist_mlp,
    )
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn import optimizer as opt
    from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache
    from tinynn_autograd_tpu.utils.datasets import one_hot, synthetic_mnist
    from tinynn_autograd_tpu.utils.device import require_gpu
    from tinynn_autograd_tpu.utils.seeder import random_seed

    DEVICE.update(require_gpu())
    enable_compile_cache()
    random_seed(0)
    batch = 128
    (tx, ty), _ = synthetic_mnist(n_train=12800, n_test=16)
    ty_oh = one_hot(ty)

    # 1. flagship MLP: 200 epochs = 20,000 steps per dispatch
    m = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), opt.Adam(1e-3))
    x_dev, y_dev = m.stage(tx, ty_oh)
    rates = _time_epochs(m, x_dev, y_dev, batch, 200, len(tx) // batch)
    emit("mnist_mlp_train_steps_per_sec", rates, vs=BASELINE)

    # 2. optimizer zoo: per-optimizer fused step cost
    for name, o in [("sgd", opt.SGD(0.01)), ("momentum", opt.Momentum(0.01)),
                    ("rmsprop", opt.RMSProp(1e-3)), ("adam", opt.Adam(1e-3))]:
        random_seed(0)
        m = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), o)
        rates = _time_epochs(m, x_dev, y_dev, batch, 200, len(tx) // batch)
        emit("mnist_mlp_%s_steps_per_sec" % name, rates)

    # 3. deep-graph stress: 100-layer stacked MLP (one dense_stack_ scan)
    rng = np.random.RandomState(0)
    dx = rng.randn(2560, 256).astype(np.float32)
    dy = one_hot(rng.randint(0, 10, 2560))
    import jax.numpy as jnp

    for name, o in [("adam", opt.Adam(1e-3)),
                    ("adam_bf16slots",
                     opt.Adam(1e-3, slot_dtype=jnp.bfloat16)),
                    ("sgd", opt.SGD(0.01))]:
        random_seed(0)
        m = Model(build_deep_mlp(num_in=256, depth=100, width=256,
                                 num_out=10, stacked=True),
                  SoftmaxCrossEntropyLoss(), o)
        dx_dev, dy_dev = m.stage(dx, dy)
        rates = _time_epochs(m, dx_dev, dy_dev, batch, 100, len(dx) // batch)
        emit("deep_mlp_100layer_%s_steps_per_sec" % name, rates)

    # 4. CNN, with a hand-written pure-JAX (jax.grad) twin timed same-run
    random_seed(0)
    m = Model(build_mnist_cnn(), SoftmaxCrossEntropyLoss(), opt.Adam(1e-3))
    cx = tx[:2560].reshape(-1, 28, 28, 1)
    cx_dev, cy_dev = m.stage(cx, ty_oh[:2560])
    rates = _time_epochs(m, cx_dev, cy_dev, batch, 150, len(cx) // batch)
    cnn_oracle = _cnn_oracle_rates(m.net, np.asarray(cx), ty_oh[:2560],
                                   batch, 150, lr=1e-3)
    emit("mnist_cnn_train_steps_per_sec", rates)
    emit("mnist_cnn_jaxgrad_oracle_steps_per_sec", cnn_oracle)

    # 5. data parallel: the DP machinery's cost vs the plain single-device
    # scanned epoch at the same global batch, on this process's devices
    from tinynn_autograd_tpu.parallel import DataParallel, make_mesh

    n_dev = len(jax.devices())
    gbatch = 1024
    random_seed(0)
    m_single = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(),
                     opt.Adam(1e-3))
    sx, sy = m_single.stage(tx[:12800], ty_oh[:12800])
    n_ep = 60
    DP_REPEATS = 7
    single_rates = []
    jax.block_until_ready(m_single.train_epochs(sx, sy, n_epochs=n_ep,
                                                batch_size=gbatch))
    for _ in range(DP_REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(m_single.train_epochs(
            sx, sy, n_epochs=n_ep, batch_size=gbatch))
        single_rates.append(n_ep * (12800 // gbatch)
                            / (time.perf_counter() - t0))
    random_seed(0)
    dp = DataParallel(Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(),
                            opt.Adam(1e-3)), mesh=make_mesh(n_dev))
    gx, gy = dp.stage(tx[:12800], ty_oh[:12800])
    jax.block_until_ready(dp.train_epochs(gx, gy, n_epochs=n_ep,
                                          batch_size=gbatch))
    dp_rates = []
    for _ in range(DP_REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(dp.train_epochs(gx, gy, n_epochs=n_ep,
                                              batch_size=gbatch))
        dp_rates.append(n_ep * (12800 // gbatch)
                        / (time.perf_counter() - t0))
    # the ratio of medians is robust to one-sided outliers; medians and
    # spreads are attached for transparency
    med_dp = statistics.median(dp_rates)
    med_single = statistics.median(single_rates)

    def spread(r):
        return 100 * (max(r) - min(r)) / statistics.median(r)

    rec = {
        "metric": "dp_path_overhead_vs_single_device",
        "value": med_single / med_dp,
        "unit": "x (scanned single-device epoch / dp epoch, same global "
                "batch, %d device(s))" % n_dev,
        "repeats": DP_REPEATS,
        "dp_median_steps_per_sec": med_dp,
        "dp_spread_pct": spread(dp_rates),
        "single_median_steps_per_sec": med_single,
        "single_spread_pct": spread(single_rates)}
    rec.update(DEVICE)
    print(json.dumps(rec), flush=True)

    # 6. transformer family + same-run jax.grad oracle
    bench_transformer()

    # 6b. long-context transformer (flash-attention regime)
    bench_transformer_long()

    # 6c. long-context WITH dropout (in-kernel hash-mask replay vs a
    # bernoulli-mask jax.grad oracle)
    bench_transformer_long_dropout()

    # 6d. long-context with SLIDING-WINDOW attention (in-band tiles only)
    bench_transformer_long_window()

    # 8. recurrent family + same-run jax.grad oracle
    bench_rnn()

    # 9. llama family (GQA + RoPE + SwiGLU at seq 1024) + same-run oracle
    bench_llama()

    # 7. north-star time-to-accuracy (BASELINE.json): seconds/epochs to
    # 97.5% test acc, post-compile, real MNIST when data/mnist.pkl.gz
    # exists (synthetic pseudo-MNIST otherwise — labeled)
    from bench import measure_time_to_accuracy

    tta = measure_time_to_accuracy()
    tta["metric"] = "mnist_mlp_time_to_975"
    tta.update(DEVICE)
    print(json.dumps(tta), flush=True)


if __name__ == "__main__":
    main()
