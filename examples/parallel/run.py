"""Parallelism demo: the same models trained under every strategy —
single device, data / tensor / pipeline parallel on an MLP, and
sequence-parallel TP / ring attention / Ulysses on a transformer — with
loss parity shown at every step (see PARALLELISM.md for the design).

Runs anywhere: on a multi-GPU host the collectives run over NVLink; on a
host with fewer accelerators than ``--mesh`` it carves the CPU into
``--mesh`` virtual devices (the same trick the test suite uses), so the
collectives and sharding are fully exercised without hardware. Usage::

    python examples/parallel/run.py --mesh 8 --steps 5
"""

import argparse
import os
import sys


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--mesh", type=int, default=8,
                        help="devices in the 1-D mesh")
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.05)
    args = parser.parse_args()

    # carve the host into enough virtual devices BEFORE jax initializes
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=%d"
            % args.mesh).strip()

    import numpy as np
    import jax

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "..", ".."))

    from tinynn_autograd_tpu.models import build_deep_mlp, \
        build_tiny_transformer
    from tinynn_autograd_tpu.nn.layers import Dense, ReLU
    from tinynn_autograd_tpu.nn.losses import SoftmaxCrossEntropyLoss
    from tinynn_autograd_tpu.nn.model import Model
    from tinynn_autograd_tpu.nn.net import Net
    from tinynn_autograd_tpu.nn.optimizer import SGD
    from tinynn_autograd_tpu.parallel import (
        ContextParallel, DataParallel, PipelineParallel, TensorParallel,
        make_mesh)
    from tinynn_autograd_tpu.utils.compile_cache import enable_compile_cache
    from tinynn_autograd_tpu.utils.seeder import random_seed

    enable_compile_cache()
    devices = jax.devices()
    if len(devices) < args.mesh:
        devices = jax.devices("cpu")
    devices = devices[: args.mesh]
    print("mesh: %d x %s" % (args.mesh, devices[0].platform))

    S = args.mesh
    rng = np.random.RandomState(0)
    x = rng.randn(args.batch, 16).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, args.batch)]

    width = 8 * S

    def fresh(kind):
        random_seed(42)
        if kind == "pp":
            net = build_deep_mlp(num_in=16, depth=S + 2, width=32, num_out=4)
        elif kind == "tf":
            net = build_tiny_transformer(vocab=4, seq_len=2 * S, dim=32,
                                         heads=S, depth=1, num_out=4)
        else:
            net = Net([Dense(width, num_in=16), ReLU(),
                       Dense(width, num_in=width), ReLU(),
                       Dense(4, num_in=width)])
        lr = args.lr * (0.1 if kind == "tf" else 1.0)
        return Model(net, SoftmaxCrossEntropyLoss(), SGD(lr=lr))

    xt = rng.randint(0, 4, (args.batch, 2 * S))

    trainers = {
        "single(wide)": fresh("flat"),
        "data-parallel": DataParallel(
            fresh("flat"), mesh=make_mesh(S, devices=devices)),
        "tensor-parallel": TensorParallel(
            fresh("flat"), mesh=make_mesh(S, axis_name="model",
                                          devices=devices)),
        "single(deep)": fresh("pp"),
        "pipeline-parallel": PipelineParallel(
            fresh("pp"), mesh=make_mesh(S, axis_name="pp", devices=devices),
            microbatches=S),
        "single(attn)": fresh("tf"),
        "seq-parallel": TensorParallel(
            fresh("tf"), mesh=make_mesh(S, axis_name="model",
                                        devices=devices),
            sequence_parallel=True),
        "ring-attention": ContextParallel(
            fresh("tf"), mesh=make_mesh(S, axis_name="ctx",
                                        devices=devices)),
        "ulysses": ContextParallel(
            fresh("tf"), mesh=make_mesh(S, axis_name="ctx",
                                        devices=devices), mode="ulysses"),
    }
    attn_names = {"single(attn)", "seq-parallel", "ring-attention",
                  "ulysses"}

    yt = np.eye(4, dtype=np.float32)[xt[:, 0]]
    print("step  " + "  ".join("%-17s" % k for k in trainers))
    for step in range(args.steps):
        losses = [
            float(t.train_step(xt, yt) if name in attn_names
                  else t.train_step(x, y))
            for name, t in trainers.items()
        ]
        print("%4d  " % step + "  ".join("%-17.6f" % v for v in losses))

    print("\nDP/TP match single(wide); PP matches single(deep); SP, ring "
          "attention and Ulysses match single(attn) — every sharded "
          "program is numerically the single-device program (remaining "
          "~1e-4 drift is float32 reduction order, plus backend "
          "differences when single models run on a real accelerator while "
          "the mesh is simulated on CPU). See PARALLELISM.md.")


if __name__ == "__main__":
    main()
