"""Device-mesh construction and collective helpers (SURVEY §2 P4).

The reference has no distributed backend at all — one process, one OpenCL
device, host<->device copies every substep
(/root/reference/nuclear_forces.py:202-234). Here the comm layer is XLA
collectives (NCCL over NVLink on a GPU host): build a `jax.sharding.Mesh`,
annotate shardings, and let the compiler insert psum/all-gather/ppermute.
This module is the small amount of glue that deserves a name.

Multi-host note: for clusters spanning hosts, call
``jax.distributed.initialize`` before ``make_mesh`` — the same code then
lays the ``data`` axis across hosts and inner axes within each host.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

DATA_AXIS = "data"   # ensemble (batch) axis — the primary scale dimension
MODEL_AXIS = "model"  # particle axis — the ring-sharded N^2 dimension (P5)


def make_mesh(
    shape: tuple[int, ...] | None = None,
    axis_names: tuple[str, ...] = (DATA_AXIS,),
    devices=None,
) -> Mesh:
    """Build a mesh over the available devices.

    Default: a 1-D ``data`` mesh over every device. Pass
    ``shape=(d, m), axis_names=('data', 'model')`` for the 2-D
    ensemble x particle layout.
    """
    if devices is None:
        devices = jax.devices()
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(shape)
    return Mesh(arr, axis_names)


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS) -> NamedSharding:
    """Sharding that splits the leading (ensemble) axis across ``axis``."""
    return NamedSharding(mesh, PartitionSpec(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def shard_ensemble(states, mesh: Mesh, axis: str = DATA_AXIS):
    """Place a batched ``NucleusState`` pytree with its batch axis split
    over the mesh. XLA then inserts every frame-step collective itself."""
    return jax.device_put(states, batch_sharding(mesh, axis))
