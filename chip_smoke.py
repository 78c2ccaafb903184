"""Smoke run of the framework on NVIDIA GPUs, through the user entry points.

    python chip_smoke.py              # one card: phases 1-5 below
    python chip_smoke.py --chips 4    # four cards: the multi-device parity
                                      # gates (DP, TP, CP, EP, PP) only

One card, each phase at the real width of its configuration; the first
fault ends the run with a non-zero exit code:

1. device: JAX's first device must be a GPU (no CPU fallback); prints its
   kind, the device count and the card's name and power limit.
2. llama: build_tiny_llama(vocab 32000, dim 512, 8 heads, 2 kv heads,
   depth 8) at seq 1024, batch 4. First-step loss and gradients of the
   tape against a jax.numpy twin differentiated by jax.grad under HIGHEST
   precision; 3 Adam ``train_step``s; the step's compiled memory
   analysis; 16 greedy tokens from 4 prompts of 128 tokens with the
   prefill and first decode-step logits checked against the full forward.
3. transformer attention cells: a few ``train_epochs`` of the seq-2048
   causal transformer, with attention dropout, with window 512, and the
   seq-128 classifier.
4. MNIST MLP and stacked LSTM: a few ``train_epochs`` each.
5. kernels vs XLA: the flash-attention kernels against the XLA twin at
   the phase-2/3 shapes (error, tolerance, median times), the train step
   end to end with each, and XLA's own time for the work that lost its
   hand-written kernels (the MLP/llama matmuls, the LSTM step).

Every comparison prints its tolerance and the reason for it. The last
line printed is the JSON verdict ``{"ok": true, "device": {...}}``.
"""

import argparse
import importlib
import json
import statistics
import time

import numpy as np

import jax
import jax.numpy as jnp

from tinynn_autograd_tpu.core.tensor import Tensor
from tinynn_autograd_tpu.models import (
    build_mnist_mlp, build_rnn_classifier, build_tiny_llama,
    build_tiny_transformer, generate,
)
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
from tinynn_autograd_tpu.nn.model import Model
from tinynn_autograd_tpu.nn.optimizer import SGD, Adam
from tinynn_autograd_tpu.ops import attention, kernels
from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache
from tinynn_autograd_tpu.utils.datasets import one_hot, synthetic_mnist
from tinynn_autograd_tpu.utils.device import card_line, require_gpu
from tinynn_autograd_tpu.utils.seeder import random_seed

# Real widths (the README's llama, bench_all.py's transformer / MNIST /
# LSTM configurations). The CPU tests run the same phases at TINY.
REAL = {
    "llama": dict(vocab=32000, dim=512, heads=8, kv_heads=2, depth=8,
                  seq=1024, batch=4, prompt=128, n_new=16),
    "cells": [
        dict(name="cls_seq128", vocab=256, seq=128, dim=256, heads=8,
             depth=4, nout=16, batch=32, causal=False),
        dict(name="causal_seq2048", vocab=256, seq=2048, dim=512, heads=8,
             depth=2, nout=16, batch=4, causal=True),
        dict(name="causal_seq2048_dropout", vocab=256, seq=2048, dim=512,
             heads=8, depth=2, nout=16, batch=4, causal=True, dropout=0.1,
             attn_dropout=0.1),
        dict(name="causal_seq2048_window512", vocab=256, seq=2048, dim=512,
             heads=8, depth=2, nout=16, batch=4, causal=True,
             attn_window=512),
    ],
    "cell_steps": 8, "cell_epochs": 4,
    "mnist": dict(n_train=12800, batch=128, epochs=3),
    "lstm": dict(t=128, d=64, hidden=(256, 256), nout=16, batch=64,
                 n_train=1024, epochs=3),
    "matmuls": [(128, 784, 200), (128, 200, 100), (4096, 512, 512),
                (4096, 512, 1368), (4096, 512, 32000)],
    "repeats": 5,
}

TINY = {
    "llama": dict(vocab=64, dim=32, heads=4, kv_heads=2, depth=2, seq=32,
                  batch=2, prompt=8, n_new=4),
    "cells": [
        dict(name="cls", vocab=16, seq=16, dim=32, heads=4, depth=1,
             nout=4, batch=8, causal=False),
        dict(name="causal_window_dropout", vocab=16, seq=32, dim=32,
             heads=4, depth=1, nout=4, batch=4, causal=True, dropout=0.1,
             attn_dropout=0.1, attn_window=8),
    ],
    "cell_steps": 4, "cell_epochs": 4,
    "mnist": dict(n_train=512, batch=64, epochs=3),
    "lstm": dict(t=8, d=6, hidden=(16, 16), nout=4, batch=16, n_train=128,
                 epochs=4),
    "matmuls": [(8, 16, 8)],
    "repeats": 2,
}


class PhaseError(AssertionError):
    """A check of the smoke run failed."""


def check(name, value, tol, reason):
    """Print one comparison with its tolerance and reason; raise past it."""
    ok = bool(np.isfinite(value)) and value <= tol
    print("  %-44s %.3e  (tol %.1e: %s)%s"
          % (name, value, tol, reason, "" if ok else "  FAILED"), flush=True)
    if not ok:
        raise PhaseError("%s = %r exceeds %r" % (name, value, tol))


def rel_err(got, want):
    """max |got - want| / max |want| over all elements."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                    1e-30))


def median_seconds(fn, repeats):
    """Median wall time of ``fn()`` over ``repeats`` calls, each closed by
    block_until_ready; one untimed call first compiles and warms up."""
    jax.block_until_ready(fn())
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def require_decrease(name, losses):
    """Finite losses whose last-epoch mean is below the first's."""
    losses = np.asarray(losses, np.float64)
    if not np.isfinite(losses).all():
        raise PhaseError("%s: non-finite loss" % name)
    first, last = losses[0].mean(), losses[-1].mean()
    print("  %-44s first epoch %.4f -> last epoch %.4f"
          % (name + " loss", first, last), flush=True)
    if not last < first:
        raise PhaseError("%s: loss did not decrease (%r -> %r)"
                         % (name, first, last))


# ------------------------------------------------------------ phase 1

def phase_device(expected_count):
    info = require_gpu()
    print("phase 1  device: %s x%d (%s)" % (
        info["device_kind"], info["device_count"], info["card"]),
        flush=True)
    if info["device_count"] < expected_count:
        raise PhaseError("need %d devices, JAX sees %d"
                         % (expected_count, info["device_count"]))
    return info


# ------------------------------------------------------------ phase 2

def _llama_data(c, seed):
    key = jax.random.PRNGKey(seed)
    ids = jax.random.randint(key, (c["batch"], c["seq"] + 1), 0, c["vocab"])
    x = ids[:, :-1]
    y = jax.nn.one_hot(ids[:, 1:], c["vocab"], dtype=jnp.float32)
    return x, y


def _build_llama(c, seed):
    random_seed(seed)
    net = build_tiny_llama(vocab=c["vocab"], dim=c["dim"], heads=c["heads"],
                           kv_heads=c["kv_heads"], depth=c["depth"])
    return Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3))


def phase_llama(c, seed=0):
    """Returns the trained model and its batch (phase 5 reuses both)."""
    import bench_all

    print("phase 2  llama vocab %(vocab)d dim %(dim)d heads %(heads)d/"
          "%(kv_heads)d depth %(depth)d seq %(seq)d batch %(batch)d" % c,
          flush=True)
    model = _build_llama(c, seed)
    net = model.net
    x, y = _llama_data(c, seed)
    net.init(x.shape)
    params0 = net.params_tree()

    def tape_loss_grads(params, xb, yb):
        net.bind_params(params)
        loss = model.loss.loss(net.forward(Tensor(xb)), Tensor(yb))
        loss.backward()
        return loss.data, net.collect_grads()

    loss_t, grads_t = jax.jit(tape_loss_grads)(params0, x, y)
    net.bind_params(params0)
    twin_params, twin_loss = bench_all.llama_oracle(net)
    with jax.default_matmul_precision("highest"):
        loss_r, g = jax.jit(jax.value_and_grad(twin_loss))(twin_params, x, y)
    grads_r = ([{"w": g["emb"]}] + g["blocks"] + [{"g": g["norm"]},
                                                   g["head"]])
    check("step-1 loss vs jax.grad twin", rel_err(loss_t, loss_r), 1e-4,
          "f32 at HIGHEST on both sides; summation order only")
    worst = max(rel_err(grads_t[i][k], grads_r[i][k])
                for i in range(len(grads_r)) for k in grads_r[i])
    check("step-1 grads vs jax.grad twin (worst leaf)", worst, 2e-3,
          "f32 on both sides; tiling/reduction order through %d layers"
          % c["depth"])

    losses = [float(model.train_step(x, y)) for _ in range(3)]
    print("  3 Adam train_steps: losses %s" % ", ".join(
        "%.4f" % v for v in losses), flush=True)
    if not np.isfinite(losses).all():
        raise PhaseError("non-finite llama train_step loss")
    step = next(fn for key, fn in model._jitted.items()
                if key[0] == "train_step")
    mem = step.lower(model._params, model._opt_state, model._buffers,
                     x, y).compile().memory_analysis()
    print("  train_step memory_analysis: %s" % (mem,), flush=True)

    _check_decode(model, c, seed)
    return model, (x, y)


def _check_decode(model, c, seed):
    gen_mod = importlib.import_module("tinynn_autograd_tpu.models.generate")
    net = model.net
    b, t0, n_new = c["batch"], c["prompt"], c["n_new"]
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(seed + 1),
                                           (b, t0), 0, c["vocab"]))
    out = np.asarray(generate(net, prompt, n_new))
    if out.shape != (b, t0 + n_new):
        raise PhaseError("generate returned %s" % (out.shape,))
    print("  generate: %d greedy tokens x %d prompts of %d" % (n_new, b, t0),
          flush=True)
    cfg, params = gen_mod._extract_any(net, b, t0, n_new)

    def first_two(params, prompt):
        with gen_mod._matmul_precision(cfg):
            logits, caches = gen_mod._run_prefill(cfg, params, prompt)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            step_logits, _ = gen_mod._make_token_logits(cfg, params)(
                tok, jnp.int32(t0), caches)
        return logits, tok, step_logits

    pre, tok, step = jax.jit(first_two)(params, jnp.asarray(prompt))
    if not np.array_equal(np.asarray(tok), out[:, t0]):
        raise PhaseError("generate's first token is not the prefill argmax")
    full = np.asarray(model.predict(
        np.concatenate([prompt, out[:, t0:t0 + 1]], axis=1)).data)
    reason = "f32 at HIGHEST; cached vs full attention, summation order"
    check("prefill logits vs full forward", rel_err(pre, full[:, t0 - 1]),
          1e-4, reason)
    check("first decode logits vs full forward", rel_err(step, full[:, t0]),
          1e-4, reason)


# ------------------------------------------------------------ phase 3

def _cell_model(c, seed=0):
    random_seed(seed)
    net = build_tiny_transformer(
        vocab=c["vocab"], seq_len=c["seq"], dim=c["dim"], heads=c["heads"],
        depth=c["depth"], num_out=c["nout"], causal=c["causal"],
        dropout=c.get("dropout", 0.0), attn_dropout=c.get("attn_dropout",
                                                           0.0),
        attn_window=c.get("attn_window"))
    return Model(net, SoftmaxCrossEntropyLoss(), Adam(1e-3))


def _cell_data(c, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, c["vocab"], (n, c["seq"]))
    return x, one_hot(x[:, 0] % c["nout"], c["nout"])


def phase_cells(cells, steps, epochs):
    print("phase 3  transformer attention cells", flush=True)
    for c in cells:
        model = _cell_model(c)
        x, y = _cell_data(c, c["batch"] * steps)
        losses = model.train_epochs(x, y, n_epochs=epochs,
                                    batch_size=c["batch"])
        require_decrease("%s (seq %d, batch %d)" % (c["name"], c["seq"],
                                                    c["batch"]), losses)


# ------------------------------------------------------------ phase 4

def phase_mnist_lstm(mn, ls):
    print("phase 4  MNIST MLP and stacked LSTM", flush=True)
    random_seed(0)
    (tx, ty), _ = synthetic_mnist(n_train=mn["n_train"], n_test=16)
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(1e-3))
    require_decrease("mnist_mlp", model.train_epochs(
        tx, one_hot(ty), n_epochs=mn["epochs"], batch_size=mn["batch"]))

    rng = np.random.RandomState(0)
    x = rng.randn(ls["n_train"], ls["t"], ls["d"]).astype(np.float32)
    y = one_hot(np.argmax(x[:, -1, :ls["nout"]], axis=1), ls["nout"])
    model = Model(build_rnn_classifier(num_in=ls["d"], num_out=ls["nout"],
                                       hidden=ls["hidden"], cell="lstm",
                                       seed=77),
                  SoftmaxCrossEntropyLoss(), Adam(1e-3))
    require_decrease("lstm_stacked", model.train_epochs(
        x, y, n_epochs=ls["epochs"], batch_size=ls["batch"]))


# ------------------------------------------------------------ phase 5

def _attn_shapes(cfg):
    """(name, B, H, Hkv, T, d, kwargs) of every attention call the
    phase-2/3 models make."""
    lc = cfg["llama"]
    shapes = [("llama", lc["batch"], lc["heads"], lc["kv_heads"], lc["seq"],
               lc["dim"] // lc["heads"], dict(causal=True))]
    for c in cfg["cells"]:
        kw = dict(causal=c["causal"])
        if c.get("attn_dropout"):
            kw.update(dropout_rate=c["attn_dropout"],
                      dropout_seed=jnp.uint32(7))
        if c.get("attn_window"):
            kw["window"] = c["attn_window"]
        shapes.append((c["name"], c["batch"], c["heads"], c["heads"],
                       c["seq"], c["dim"] // c["heads"], kw))
    return shapes


def compare_attention(cfg, kernel_impl, repeats):
    """Kernel vs XLA twin at each attention shape: errors of o/lse and
    dq/dk/dv, median times of forward and forward+backward."""
    rows = []
    for name, b, h, hkv, t, d, kw in _attn_shapes(cfg):
        rng = np.random.RandomState(0)
        q, do = (jnp.asarray(rng.randn(b, h, t, d), jnp.float32)
                 for _ in range(2))
        k, v = (jnp.asarray(rng.randn(b, hkv, t, d), jnp.float32)
                for _ in range(2))

        def fwd(impl):
            return jax.jit(lambda q, k, v: attention.mha_fwd(
                q, k, v, impl=impl, **kw))

        def fwd_bwd(impl):
            def f(q, k, v, do):
                o, lse = attention.mha_fwd(q, k, v, impl=impl, **kw)
                return attention.mha_bwd(q, k, v, o, lse, do, impl=impl,
                                         **kw)
            return jax.jit(f)

        out = {}
        for impl in ("xla", kernel_impl):
            f, fb = fwd(impl), fwd_bwd(impl)
            out[impl] = (f(q, k, v), fb(q, k, v, do),
                         median_seconds(lambda: f(q, k, v), repeats),
                         median_seconds(lambda: fb(q, k, v, do), repeats))
        (o_x, g_x, tf_x, tb_x) = out["xla"]
        (o_k, g_k, tf_k, tb_k) = out[kernel_impl]
        err_f = max(rel_err(a, bb) for a, bb in zip(o_k, o_x))
        err_b = max(rel_err(a, bb) for a, bb in zip(g_k, g_x))
        reason = ("f32: TF32x3 dots in the kernel, HIGHEST in the twin; "
                  "online vs two-pass softmax order")
        check("%s fwd o/lse kernel vs twin" % name, err_f, 1e-4, reason)
        check("%s bwd dq/dk/dv kernel vs twin" % name, err_b, 1e-4, reason)
        print("  %-44s fwd %.1f us (xla %.1f)  fwd+bwd %.1f us (xla %.1f)"
              % (name + " kernel times", tf_k * 1e6, tf_x * 1e6,
                 tb_k * 1e6, tb_x * 1e6), flush=True)
        rows.append(dict(shape=name, b=b, h=h, hkv=hkv, t=t, d=d,
                         fwd_us_kernel=tf_k * 1e6, fwd_us_xla=tf_x * 1e6,
                         fwdbwd_us_kernel=tb_k * 1e6,
                         fwdbwd_us_xla=tb_x * 1e6))
    return rows


def train_step_seconds(make_model, data, impl, repeats):
    """Median seconds of one Model.train_step with every attention call
    traced as ``impl`` (None: the automatic dispatch)."""
    model = make_model()
    x, y = data
    with attention.use_impl(impl):
        jax.block_until_ready(model.train_step(x, y))
    return median_seconds(lambda: model.train_step(x, y), repeats)


def phase_kernels(cfg, kernel_impl="pallas"):
    print("phase 5  kernels vs XLA (%s)" % card_line(), flush=True)
    reps = cfg["repeats"]
    rows = compare_attention(cfg, kernel_impl, reps)

    lc = cfg["llama"]
    e2e = [("llama", lambda: _build_llama(lc, 0), _llama_data(lc, 0))]
    for c in (min(cfg["cells"], key=lambda c: c["seq"]),
              max(cfg["cells"], key=lambda c: c["seq"])):
        e2e.append((c["name"], lambda c=c: _cell_model(c),
                    _cell_data(c, c["batch"])))
    for name, make, data in e2e:
        t_k = train_step_seconds(make, data, kernel_impl, reps)
        t_x = train_step_seconds(make, data, "xla", reps)
        print("  %-44s kernels %.3f ms  xla twin %.3f ms"
              % (name + " train_step end to end", t_k * 1e3, t_x * 1e3),
              flush=True)
        rows.append(dict(shape=name + "_train_step", kernel_ms=t_k * 1e3,
                         xla_ms=t_x * 1e3))

    for m, k, n in cfg["matmuls"]:
        a = jnp.ones((m, k), jnp.float32)
        b = jnp.ones((k, n), jnp.float32)
        f = jax.jit(kernels.matmul)
        t = median_seconds(lambda: f(a, b), reps)
        print("  %-44s %.1f us" % ("XLA f32 dot [%d,%d]x[%d,%d]"
                                   % (m, k, k, n), t * 1e6), flush=True)
        rows.append(dict(shape="dot_%dx%dx%d" % (m, k, n), xla_us=t * 1e6))

    ls = cfg["lstm"]
    random_seed(0)
    lstm = Model(build_rnn_classifier(num_in=ls["d"], num_out=ls["nout"],
                                      hidden=ls["hidden"], cell="lstm",
                                      seed=77),
                 SoftmaxCrossEntropyLoss(), SGD(1e-2))
    rng = np.random.RandomState(0)
    xb = jnp.asarray(rng.randn(ls["batch"], ls["t"], ls["d"]), jnp.float32)
    yb = jnp.asarray(one_hot(rng.randint(0, ls["nout"], ls["batch"]),
                             ls["nout"]))
    t = median_seconds(lambda: lstm.train_step(xb, yb), reps)
    per = t / (ls["t"] * len(ls["hidden"]))
    print("  %-44s %.3f ms/step, %.2f us per layer-timestep (fwd+bwd)"
          % ("LSTM %dx%d T=%d B=%d train_step (XLA scan)"
             % (len(ls["hidden"]), ls["hidden"][0], ls["t"], ls["batch"]),
             t * 1e3, per * 1e6), flush=True)
    rows.append(dict(shape="lstm_train_step", xla_ms=t * 1e3,
                     us_per_layer_timestep=per * 1e6))
    return rows


# ------------------------------------------------------ multi-device

def _parity(name, wrapped, ref, data, steps, rtol, reason):
    """``steps`` train_steps of the wrapped model and its single-device
    twin on the same batches: the worst relative loss gap, checked."""
    x, y = data
    worst = 0.0
    for _ in range(steps):
        a = float(wrapped.train_step(x, y))
        b = float(ref.train_step(x, y))
        worst = max(worst, abs(a - b) / max(abs(b), 1e-30))
    check("%s loss vs single device" % name, worst, rtol, reason)


def phase_multichip(n, sizes=None):
    """DP (MLP, llama), TP (llama), ring CP (causal llama), a2a EP and
    PP on an n-device mesh, each against single-device training of the
    same model in this process."""
    from tinynn_autograd_tpu.models import build_deep_mlp
    from tinynn_autograd_tpu.nn.layers import Dense, MoE, ReLU
    from tinynn_autograd_tpu.nn.net import Net
    from tinynn_autograd_tpu.parallel import (
        ContextParallel, DataParallel, ExpertParallel, PipelineParallel,
        TensorParallel, make_mesh)

    s = sizes or dict(llama=dict(vocab=32000, dim=512, heads=8, depth=2,
                                 seq=1024, batch=2 * n),
                      cp_seq=4096, mlp_batch=128 * n, moe_dim=512,
                      pp_width=1024, steps=2)
    lc = s["llama"]
    devs = jax.devices()[:n]
    steps = s["steps"]
    reason = "f32 at HIGHEST; cross-device reduction order"
    print("multi-device  %d x %s" % (n, devs[0].device_kind), flush=True)

    def mlp(seed):
        random_seed(seed)
        return Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), SGD(0.1))

    (tx, ty), _ = synthetic_mnist(n_train=s["mlp_batch"], n_test=16)
    _parity("DP mnist_mlp", DataParallel(mlp(1), mesh=make_mesh(
        n, devices=devs)), mlp(1), (tx, one_hot(ty)), steps, 2e-4, reason)

    def llama(seed, kv, seq):
        random_seed(seed)
        net = build_tiny_llama(vocab=lc["vocab"], dim=lc["dim"],
                               heads=lc["heads"], kv_heads=kv,
                               depth=lc["depth"])
        return Model(net, SoftmaxCrossEntropyLoss(), SGD(0.05))

    def llama_data(seq, batch):
        return _llama_data(dict(lc, seq=seq, batch=batch), 0)

    data = llama_data(lc["seq"], lc["batch"])
    _parity("DP llama", DataParallel(llama(2, 2, lc["seq"]), mesh=make_mesh(
        n, devices=devs)), llama(2, 2, lc["seq"]), data, steps, 2e-4,
        reason)
    # kv-head column shards: the kv heads must divide over the mesh
    _parity("TP llama (%d kv heads)" % n, TensorParallel(
        llama(3, n, lc["seq"]), mesh=make_mesh(n, axis_name="model",
                                               devices=devs)),
        llama(3, n, lc["seq"]), data, steps, 3e-4, reason)
    cp_data = llama_data(s["cp_seq"], 1)
    _parity("ring CP llama seq %d" % s["cp_seq"], ContextParallel(
        llama(4, 2, s["cp_seq"]), mesh=make_mesh(n, axis_name="ctx",
                                                 devices=devs)),
        llama(4, 2, s["cp_seq"]), cp_data, steps, 3e-4, reason)

    dim = s["moe_dim"]

    def moe(seed):
        random_seed(seed)
        net = Net([Dense(dim, num_in=784), ReLU(),
                   MoE(num_experts=2 * n, dim=dim, hidden=4 * dim),
                   Dense(10, num_in=dim)])
        return Model(net, SoftmaxCrossEntropyLoss(), SGD(0.1))

    ep = ExpertParallel(moe(5), mesh=make_mesh(n, axis_name="expert",
                                               devices=devs),
                        dispatch="a2a", capacity_factor=float(4 * n),
                        aux_loss_weight=0.0)
    _parity("EP a2a moe", ep, moe(5), (tx, one_hot(ty)), steps, 3e-4,
            reason + "; capacity large enough that no token drops")
    if int(ep.last_stats["dropped"]):
        raise PhaseError("EP a2a dropped tokens")

    def deep(seed):
        random_seed(seed)
        net = build_deep_mlp(num_in=784, depth=n + 2, width=s["pp_width"],
                             num_out=10)
        return Model(net, SoftmaxCrossEntropyLoss(), SGD(0.05))

    _parity("PP deep_mlp", PipelineParallel(
        deep(6), mesh=make_mesh(n, axis_name="pp", devices=devs),
        microbatches=n), deep(6), (tx, one_hot(ty)), steps, 3e-4, reason)


# ---------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device parity gates")
    args = ap.parse_args(argv)

    enable_compile_cache()
    t0 = time.perf_counter()
    phase_device(args.chips)
    if args.chips == 4:
        phase_multichip(4)
    else:
        cfg = REAL
        phase_llama(cfg["llama"])
        phase_cells(cfg["cells"], cfg["cell_steps"], cfg["cell_epochs"])
        phase_mnist_lstm(cfg["mnist"], cfg["lstm"])
        phase_kernels(cfg)
    print("all phases passed in %.1f s" % (time.perf_counter() - t0))
    print(card_line())
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
