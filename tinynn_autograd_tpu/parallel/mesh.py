"""Device mesh helpers.

The reference has no parallelism of any kind (SURVEY.md §2.2: no collective
library, single process). The communication backend is JAX's collectives:
build a ``jax.sharding.Mesh``, annotate shardings, and let XLA lower
psum/all-gather/all-to-all to the devices' collective library (NCCL on
GPUs). The cards of one host reach each other all to all at the same rate,
so a mesh's axes are laid out by the algorithm alone.
"""

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def make_mesh(n_devices=None, axis_name="data", devices=None):
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    if n > len(devices):
        raise ValueError(
            "Requested %d devices, only %d available" % (n, len(devices)))
    return Mesh(np.array(devices[:n]), (axis_name,))


def make_mesh_2d(shape, axis_names=("data", "model"), devices=None):
    """2-D mesh, e.g. shape=(2, 4) for 2-way data x 4-way model
    parallelism."""
    if devices is None:
        devices = jax.devices()
    n = shape[0] * shape[1]
    if n > len(devices):
        raise ValueError(
            "Requested %d devices, only %d available" % (n, len(devices)))
    return Mesh(np.array(devices[:n]).reshape(shape), tuple(axis_names))


def batch_sharding(mesh, axis_name="data"):
    """NamedSharding that splits the leading (batch) dim over the mesh."""
    return NamedSharding(mesh, PartitionSpec(axis_name))


def replicated_sharding(mesh):
    return NamedSharding(mesh, PartitionSpec())
