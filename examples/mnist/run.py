"""MNIST training example (reference surface: examples/mnist/run.py).

Same flags (--num_ep/--data_dir/--lr/--batch_size/--seed, reference:
run.py:97-103) and the same flagship MLP (784-200-100-70-30-10 Dense+ReLU,
Adam, batch 128, reference: run.py:59-71), rebuilt on the jitted stack:

- default mode runs the FUSED jitted train step (forward + tape backward +
  optimizer as one XLA program, buffers donated); --eager runs the
  reference-style per-op loop for comparison
- --model cnn trains the Conv2D+MaxPool CNN (driver config #4)
- --dp N trains data-parallel over an N-device mesh (gradient psum)
- offline-safe: falls back to synthetic pseudo-MNIST when the download is
  unavailable (zero-egress environments)

Run:  python examples/mnist/run.py --num_ep 10
      (JAX_PLATFORMS=cpu to run on the host instead of the accelerator)
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from tinynn_autograd_tpu import Tensor  # noqa: E402
from tinynn_autograd_tpu.models import build_mnist_cnn, build_mnist_mlp  # noqa: E402
from tinynn_autograd_tpu.nn.evaluator import AccEvaluator  # noqa: E402
from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss  # noqa: E402
from tinynn_autograd_tpu.nn.model import Model  # noqa: E402
from tinynn_autograd_tpu.nn.optimizer import Adam  # noqa: E402
from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from tinynn_autograd_tpu.utils.data_iterator import BatchIterator  # noqa: E402
from tinynn_autograd_tpu.utils.datasets import load_mnist, one_hot  # noqa: E402
from tinynn_autograd_tpu.utils.seeder import random_seed  # noqa: E402


def main(args):
    if args.seed >= 0:
        random_seed(args.seed)

    (train_x, train_y), (test_x, test_y) = load_mnist(args.data_dir)
    train_y_oh = one_hot(train_y)

    if args.model == "cnn":
        net = build_mnist_cnn()
        train_x = train_x.reshape(-1, 28, 28, 1)
        test_x = test_x.reshape(-1, 28, 28, 1)
    else:
        net = build_mnist_mlp()

    model = Model(net, SoftmaxCrossEntropyLoss(), Adam(lr=args.lr))

    if args.dp > 1:
        from tinynn_autograd_tpu.parallel import DataParallel, make_mesh

        trainer = DataParallel(model, mesh=make_mesh(args.dp))
        if args.accum > 1:
            def step(xb, yb):
                return trainer.train_step(xb, yb, accum_steps=args.accum)
        else:
            step = trainer.train_step
    elif args.eager:
        def step(xb, yb):
            model.zero_grad()
            pred = model.forward(Tensor(xb))
            loss = model.loss.loss(pred, Tensor(yb))
            loss.backward()
            model.step()
            return loss.values
    elif args.accum > 1:
        def step(xb, yb):
            return model.train_step(xb, yb, accum_steps=args.accum)
    else:
        step = model.train_step

    epoch_mode = args.dp <= 1 and not args.eager and args.accum <= 1
    if epoch_mode:
        # stage the dataset into device memory once; each epoch is ONE
        # device dispatch (on-device shuffle + scanned fused steps)
        x_dev, y_dev = model.stage(train_x, train_y_oh)

    iterator = BatchIterator(batch_size=args.batch_size,
                             drop_last=not args.eager)
    target_acc = args.target_acc
    t_start = time.time()
    reached_at = None

    profile_cm = None
    for epoch in range(args.num_ep):
        if args.profile and epoch == 1:  # skip the compile epoch
            from tinynn_autograd_tpu.utils import profiler

            profile_cm = profiler.trace(args.profile)
            profile_cm.__enter__()
        t_epoch = time.time()
        if epoch_mode:
            losses = model.train_epoch(x_dev, y_dev,
                                       batch_size=args.batch_size)
            n_steps = int(losses.shape[0])
            loss_val = float(np.asarray(losses)[-1])
        else:
            loss = None
            n_steps = 0
            for batch in iterator(train_x, train_y_oh):
                loss = step(batch.inputs, batch.targets)
                n_steps += 1
            loss_val = float(loss.values if isinstance(loss, Tensor) else loss)
        epoch_s = time.time() - t_epoch

        model.set_phase("TEST")
        preds = model.predict(test_x)
        pred_idx = np.argmax(preds.numpy(), axis=1)
        res = AccEvaluator.evaluate(pred_idx, test_y)
        model.set_phase("TRAIN")

        print("Epoch %d  time %.2fs (%.1f steps/s)  loss %.4f  %s"
              % (epoch, epoch_s, n_steps / epoch_s, loss_val, res))
        if reached_at is None and res["accuracy"] >= target_acc:
            reached_at = time.time() - t_start
            print("Reached %.3f test accuracy in %.2fs" % (target_acc, reached_at))

        if profile_cm is not None and epoch == 1:
            profile_cm.__exit__(None, None, None)
            profile_cm = None
            print("Profiler trace written to %s" % args.profile)

    if args.ckpt:
        model.save(args.ckpt)
    if args.export:
        model.export_stablehlo(args.export, test_x[: args.batch_size])
        print("Exported StableHLO inference fn to %s" % args.export)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_ep", default=50, type=int)
    parser.add_argument("--data_dir", default="./data", type=str)
    parser.add_argument("--lr", default=1e-3, type=float)
    parser.add_argument("--batch_size", default=128, type=int)
    parser.add_argument("--seed", default=-1, type=int)
    parser.add_argument("--model", default="mlp", choices=("mlp", "cnn"))
    parser.add_argument("--eager", action="store_true",
                        help="reference-style per-op eager loop")
    parser.add_argument("--dp", default=0, type=int,
                        help="data-parallel over N mesh devices")
    parser.add_argument("--target_acc", default=0.975, type=float)
    parser.add_argument("--accum", default=1, type=int,
                        help="gradient accumulation: microbatches per "
                             "optimizer update (batch_size must divide; "
                             "runs the per-step path)")
    parser.add_argument("--ckpt", default="", type=str)
    parser.add_argument("--profile", default="", type=str,
                        help="write a jax.profiler trace of epoch 1 here")
    parser.add_argument("--export", default="", type=str,
                        help="serialize the trained forward as StableHLO")
    args = parser.parse_args()
    enable_compile_cache()
    main(args)
