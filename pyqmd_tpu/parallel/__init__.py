"""Parallelism: device meshes, sharded ensembles, ring-sharded forces.

The reference is single-process/single-device (SURVEY §2 "Parallelism &
communication"); these modules are the capability-equivalent multi-device scale-out:
P1 ensemble data parallelism, P3 psum'd statistics, P4 mesh/collective
helpers, P5 particle-axis ring sharding.
"""

from pyqmd_tpu.parallel.ensemble import (
    make_sharded_decay_fn,
    make_sharded_frame_fn,
    make_sharded_run_fn,
    survival_fraction,
)
from pyqmd_tpu.parallel.hybrid import make_hybrid_frame_fn
from pyqmd_tpu.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    replicated,
    shard_ensemble,
)
from pyqmd_tpu.parallel.multihost import initialize_multihost, local_batch_slice
from pyqmd_tpu.parallel.ring import make_ring_force_step, make_ring_frame_fn

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "make_mesh",
    "initialize_multihost",
    "local_batch_slice",
    "make_hybrid_frame_fn",
    "make_ring_force_step",
    "make_ring_frame_fn",
    "make_sharded_decay_fn",
    "make_sharded_frame_fn",
    "make_sharded_run_fn",
    "replicated",
    "shard_ensemble",
    "survival_fraction",
]
