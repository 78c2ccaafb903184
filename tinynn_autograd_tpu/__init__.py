"""tinynn_autograd_tpu: a tape-based autodiff framework on JAX/XLA.

A from-scratch rebuild of the capabilities of borgwang/tinynn-autograd
designed for accelerators: tensors are device-resident jax.Arrays,
reverse-mode autodiff is our own tape (not jax.grad), attention runs in
Pallas flash kernels on the GPU, whole train steps fuse into single XLA
programs, and scaling is mesh parallelism over XLA collectives.
"""

from tinynn_autograd_tpu.core.tensor import Tensor, as_tensor
from tinynn_autograd_tpu import ops
from tinynn_autograd_tpu.nn import Model, Net
from tinynn_autograd_tpu.nn import layers, losses, optimizer, initializer, evaluator, scheduler
from tinynn_autograd_tpu import utils

__version__ = "0.1.0"

__all__ = [
    "Tensor", "as_tensor", "ops", "Model", "Net", "layers", "losses",
    "optimizer", "initializer", "evaluator", "scheduler", "utils",
    "__version__",
]
