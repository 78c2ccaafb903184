"""Recurrent sequence-learning demo: a stacked LSTM/GRU classifier trained
on the ADDING PROBLEM (Hochreiter & Schmidhuber's classic long-range memory
task: each sequence carries T (value, marker) pairs, exactly two markers are
set, and the target is the sum of the two marked values — a model must
remember marked values across the whole sequence). End-to-end on the tape
(hand-written reverse-scan BPTT — no jax.grad anywhere). Usage::

    python examples/rnn/run.py --steps 1200 --cell lstm
    JAX_PLATFORMS=cpu python examples/rnn/run.py --cell gru
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "..", ".."))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=1200)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--seq_len", type=int, default=32)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--cell", choices=["lstm", "gru"], default="lstm")
    parser.add_argument("--bi", action="store_true",
                        help="bidirectional recurrence (forward + "
                             "reverse-time twin, features concatenated)")
    parser.add_argument("--lr", type=float, default=1e-2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import numpy as np

    from tinynn_autograd_tpu.core.tensor import Tensor
    from tinynn_autograd_tpu.models import build_rnn_classifier
    from tinynn_autograd_tpu.nn.losses import MSELoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.optimizer import Adam
    from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache
    from tinynn_autograd_tpu.utils.seeder import random_seed

    enable_compile_cache()
    random_seed(args.seed)
    T = args.seq_len
    rng = np.random.RandomState(args.seed)

    def sample(n):
        vals = rng.rand(n, T).astype(np.float32)
        marks = np.zeros((n, T), np.float32)
        for i in range(n):
            a, b = rng.choice(T, size=2, replace=False)
            marks[i, a] = marks[i, b] = 1.0
        x = np.stack([vals, marks], axis=-1)          # [n, T, 2]
        y = (vals * marks).sum(axis=1, keepdims=True)  # [n, 1]
        return x, y

    if args.bi:
        from tinynn_autograd_tpu.nn.layers import (
            Bidirectional, Dense, LSTM, GRU,
        )
        from tinynn_autograd_tpu.nn.net import Net

        cell_cls = {"lstm": LSTM, "gru": GRU}[args.cell]
        net = Net([Bidirectional(cell_cls(args.hidden, num_in=2,
                                          seed=args.seed)),
                   Dense(1, num_in=2 * args.hidden, seed=args.seed + 1)])
    else:
        net = build_rnn_classifier(num_in=2, num_out=1,
                                   hidden=(args.hidden,),
                                   cell=args.cell, seed=args.seed)
    model = Model(net, MSELoss(), Adam(args.lr))

    # the trivial predict-the-mean baseline has MSE = Var[y] ~ 0.167;
    # a recurrent model that actually uses its memory goes far below it
    for step in range(args.steps):
        x, y = sample(args.batch)
        loss = float(model.train_step(x, y))
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print("step %4d  mse %.5f" % (step, loss))

    x, y = sample(1024)
    pred = np.asarray(model.forward(Tensor(x)).data)
    mse = float(((pred - y) ** 2).mean())
    base = float(((y - y.mean()) ** 2).mean())
    print("eval mse %.5f  (predict-the-mean baseline %.5f, ratio %.3f)"
          % (mse, base, mse / base))


if __name__ == "__main__":
    main()
