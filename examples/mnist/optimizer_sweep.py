"""Optimizer zoo parity sweep on the MNIST MLP (driver config #2).

Trains the flagship MLP with each of the seven optimizers for a few epochs
using the fused scanned-epoch path and reports final loss + test accuracy —
the sweep the reference enables but never ships a driver for.

Run:  python examples/mnist/optimizer_sweep.py --num_ep 3
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from tinynn_autograd_tpu.models import build_mnist_mlp  # noqa: E402
from tinynn_autograd_tpu.nn.evaluator import AccEvaluator  # noqa: E402
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss  # noqa: E402
from tinynn_autograd_tpu.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu.nn import optimizer as opt  # noqa: E402
from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from tinynn_autograd_tpu.utils.datasets import load_mnist, one_hot  # noqa: E402
from tinynn_autograd_tpu.utils.seeder import random_seed  # noqa: E402


# per-optimizer lr scaling: Adagrad/SGD need a much larger base lr than the
# adaptive-moment optimizers (classic; their effective step decays with t)
OPTIMIZERS = {
    "sgd": lambda lr: opt.SGD(lr=lr * 30),
    "momentum": lambda lr: opt.Momentum(lr=lr * 10, momentum=0.9),
    "adam": lambda lr: opt.Adam(lr=lr),
    "rmsprop": lambda lr: opt.RMSProp(lr=lr),
    "adagrad": lambda lr: opt.Adagrad(lr=lr * 3),   # slow starter: first steps are ±lr by construction
    "adadelta": lambda lr: opt.Adadelta(lr=1.0),
    # Lion: sign updates want ~10x smaller lr than Adam (paper recipe)
    "lion": lambda lr: opt.Lion(lr=lr * 0.1),
}


def main(args):
    (train_x, train_y), (test_x, test_y) = load_mnist(args.data_dir)
    train_y_oh = one_hot(train_y)

    results = {}
    for name, make_opt in OPTIMIZERS.items():
        random_seed(args.seed)
        model = Model(build_mnist_mlp(), SoftmaxCrossEntropyLoss(),
                      make_opt(args.lr))
        x_dev, y_dev = model.stage(train_x, train_y_oh)
        t0 = time.time()
        for _ in range(args.num_ep):
            losses = model.train_epoch(x_dev, y_dev,
                                       batch_size=args.batch_size)
        final_loss = float(np.asarray(losses)[-20:].mean())
        train_s = time.time() - t0

        model.set_phase("TEST")
        pred = np.argmax(model.predict(test_x).numpy(), axis=1)
        acc = AccEvaluator.evaluate(pred, test_y)["accuracy"]
        results[name] = (final_loss, acc, train_s)
        print("%-9s loss %.4f  acc %.4f  (%.1fs)" % (name, final_loss, acc,
                                                     train_s))

    best = max(results, key=lambda k: results[k][1])
    print("best: %s (acc %.4f)" % (best, results[best][1]))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_ep", default=3, type=int)
    parser.add_argument("--data_dir", default="./data", type=str)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--seed", default=31, type=int)
    args = parser.parse_args()
    enable_compile_cache()
    main(args)
