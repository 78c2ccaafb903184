"""Regression example: MLP on a synthetic nonlinear target, exercising the
regression losses (MSE/MAE/Huber) and the regression evaluators
(EV/MSE/MAE/R2 — the reference stubs several of these).

Run:  python examples/regression/run.py --num_ep 30
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from tinynn_autograd_tpu.nn.evaluator import (  # noqa: E402
    EVEvaluator, MAEEvaluator, MSEEvaluator, R2Evaluator,
)
from tinynn_autograd_tpu.nn.layers import Dense, Tanh  # noqa: E402
from tinynn_autograd_tpu.nn.losses import HuberLoss, MAELoss, MSELoss  # noqa: E402
from tinynn_autograd_tpu.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu.nn.net import Net  # noqa: E402
from tinynn_autograd_tpu.nn.optimizer import Adam  # noqa: E402
from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from tinynn_autograd_tpu.utils.seeder import random_seed  # noqa: E402

LOSSES = {"mse": MSELoss, "mae": MAELoss, "huber": HuberLoss}


def make_data(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2, 2, (n, 4)).astype(np.float32)
    y = np.stack([
        np.sin(x[:, 0]) + 0.5 * x[:, 1] ** 2,
        np.cos(x[:, 2]) * x[:, 3],
    ], axis=1).astype(np.float32)
    y += 0.05 * rng.randn(*y.shape).astype(np.float32)
    return x, y


def main(args):
    random_seed(args.seed)
    train_x, train_y = make_data(8192, 0)
    test_x, test_y = make_data(1024, 1)

    net = Net([Dense(64), Tanh(), Dense(64), Tanh(), Dense(2)])
    model = Model(net, LOSSES[args.loss](), Adam(lr=args.lr))

    hist = model.fit(train_x, train_y, epochs=args.num_ep,
                     batch_size=args.batch_size, verbose=False)
    print("final train loss: %.4f" % hist["loss"][-1])

    model.set_phase("TEST")
    preds = model.predict(test_x).numpy()
    for ev in (MSEEvaluator, MAEEvaluator, EVEvaluator, R2Evaluator):
        print(ev.__name__, ev.evaluate(preds, test_y))


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_ep", default=30, type=int)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--seed", default=31, type=int)
    parser.add_argument("--loss", default="mse", choices=tuple(LOSSES))
    args = parser.parse_args()
    enable_compile_cache()
    main(args)
