"""Headline benchmark: MNIST MLP fused-train-step throughput on one chip.

Exact flagship config (reference: examples/mnist/run.py:59-71,98-101):
784-200-100-70-30-10 Dense+ReLU, softmax-CE, Adam lr=1e-3, batch 128.
Baseline: the reference's measured 45.9 steps/s on CPU/NumPy eager
(BASELINE.md; measured on synthetic batches, FLOP-identical — same
methodology used here).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}, the
device it ran on (platform, device_kind, device_count, card name and power
limit), plus the time-to-accuracy north-star fields (BASELINE.json:
"time-to-97.5% test acc"): seconds and epochs to 97.5% test accuracy with per-epoch evals,
measured post-compile on real MNIST when ``data/mnist.pkl.gz`` is present
(``tta_task: "real"``) and the synthetic pseudo-MNIST stand-in otherwise.
It refuses to run without a GPU.
"""

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

BASELINE_STEPS_PER_SEC = 45.9
TTA_TARGET = 0.975
TTA_MAX_EPOCHS = 50  # the reference example trains 50 epochs


def measure_time_to_accuracy(target=TTA_TARGET, max_epochs=TTA_MAX_EPOCHS,
                             batch=128, require_real=False):
    """North-star metric: wall seconds / epochs until test accuracy crosses
    ``target``, per-epoch one-dispatch training + jitted eval.

    Compile time is excluded the honest way: the SAME Model instance is
    warmed up (compiling the epoch runner and the eval forward), then its
    parameters and optimizer state are RESET to a fresh seeded draw — the
    compiled executables are shape-keyed, so the timed run replays real
    training from scratch with zero compile in the loop.
    Returns a dict of result fields (tta_*)."""
    import os

    import jax

    from tinynn_autograd_tpu.models import build_mnist_mlp
    from tinynn_autograd_tpu.nn.evaluator import AccEvaluator
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.optimizer import Adam
    from tinynn_autograd_tpu.utils.datasets import (
        load_mnist, one_hot, synthetic_mnist,
    )
    from tinynn_autograd_tpu.utils.seeder import random_seed

    task = "real" if os.path.exists("data/mnist.pkl.gz") else "synthetic"
    if require_real and task != "real":
        raise SystemExit(
            "--require-real: data/mnist.pkl.gz is not present — refusing "
            "to silently benchmark the synthetic stand-in. Pre-place the "
            "mnielsen mnist.pkl.gz (optionally pinned via "
            "TINYNN_MNIST_SHA256) and re-run.")
    # real path: checksum-audited + structurally validated by load_mnist;
    # without the file the benchmark never tries a download
    (tx, ty), (ex, ey) = (load_mnist() if task == "real"
                          else synthetic_mnist())
    digest = None
    if task == "real":
        from tinynn_autograd_tpu.utils.datasets import file_sha256

        digest = file_sha256("data/mnist.pkl.gz")
    ty_oh = one_hot(ty)
    n_train = (len(tx) // batch) * batch

    random_seed(0)
    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(),
                  Adam(lr=1e-3))
    x_dev, y_dev = model.stage(tx[:n_train], ty_oh[:n_train])
    ex_dev = model.stage(ex)
    evaluator = AccEvaluator()

    # warmup: compiles the 1-epoch runner + the TEST-phase predict
    model.train_epoch(x_dev, y_dev, batch_size=batch)
    model.evaluate_batch(ex_dev, ey, evaluator)

    # reset to a fresh seeded draw; compiled runners are shape-keyed so
    # the timed loop replays from-scratch training with zero compiles
    random_seed(0)
    net2 = build_mnist_mlp()
    net2.init((batch, 784))
    fresh = net2.params_tree()
    model._params = jax.tree.map(jax.numpy.asarray, fresh)
    model._opt_state = model.optimizer.init_state(model._params)
    model.optimizer.load_state_dict(model._opt_state)
    model.net.bind_params(model._params)

    accs = []
    t0 = time.perf_counter()
    tta_s = tta_epochs = None
    for epoch in range(1, max_epochs + 1):
        model.train_epoch(x_dev, y_dev, batch_size=batch)
        res = model.evaluate_batch(ex_dev, ey, evaluator)
        accs.append(res["accuracy"])
        if res["accuracy"] >= target:
            tta_s = time.perf_counter() - t0
            tta_epochs = epoch
            break
    out = {
        "tta_task": task,
        "tta_target": target,
        "tta_seconds": round(tta_s, 4) if tta_s is not None else None,
        "tta_epochs": tta_epochs,
        "tta_final_acc": round(accs[-1], 4) if accs else None,
    }
    if digest is not None:
        out["tta_data_sha256"] = digest
    return out


def main():
    import os

    require_real = "--require-real" in sys.argv
    if require_real and not os.path.exists("data/mnist.pkl.gz"):
        # fail LOUDLY and immediately — before any compile/bench work —
        # instead of silently labeling the run synthetic
        raise SystemExit(
            "--require-real: data/mnist.pkl.gz is not present — refusing "
            "to benchmark the synthetic stand-in. Pre-place the mnielsen "
            "mnist.pkl.gz (optionally pinned via TINYNN_MNIST_SHA256) "
            "and re-run.")

    import jax

    from tinynn_autograd_tpu.models import build_mnist_mlp
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.optimizer import Adam
    from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache
    from tinynn_autograd_tpu.utils.datasets import synthetic_mnist, one_hot
    from tinynn_autograd_tpu.utils.device import require_gpu
    from tinynn_autograd_tpu.utils.seeder import random_seed

    device = require_gpu()
    enable_compile_cache()
    random_seed(0)
    (train_x, train_y), _ = synthetic_mnist(n_train=12800, n_test=16)
    train_y = one_hot(train_y)

    model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(), Adam(lr=1e-3))

    batch = 128
    # stage the dataset into HBM once; epochs then run as ONE dispatch each
    # (lax.scan over the fused step) with zero host<->device traffic
    x_dev, y_dev = model.stage(train_x, train_y)
    steps_per_epoch = len(train_x) // batch

    # warmup with the SAME n_epochs: the epoch count is baked into the
    # compiled program, so a different count would recompile mid-measurement
    n_epochs = 200
    jax.block_until_ready(model.train_epochs(x_dev, y_dev,
                                             n_epochs=n_epochs,
                                             batch_size=batch))

    # the whole measured run is ONE device dispatch (outer lax.scan over
    # epochs around the scanned epoch); MEDIAN of 3 runs
    rates = []
    for _ in range(3):
        start = time.perf_counter()
        losses = jax.block_until_ready(model.train_epochs(
            x_dev, y_dev, n_epochs=n_epochs, batch_size=batch))
        elapsed = time.perf_counter() - start
        final_loss = float(np.asarray(losses)[-1, -1])
        assert np.isfinite(final_loss)
        rates.append(n_epochs * steps_per_epoch / elapsed)

    steps_per_sec = sorted(rates)[1]
    rec = {
        "metric": "mnist_mlp_train_steps_per_sec",
        "value": round(steps_per_sec, 2),
        "unit": "steps/s",
        "vs_baseline": round(steps_per_sec / BASELINE_STEPS_PER_SEC, 2),
    }
    rec.update(device)
    rec.update(measure_time_to_accuracy(require_real=require_real))
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
