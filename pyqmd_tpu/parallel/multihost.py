"""Multi-host initialization.

The reference is one process on one device (SURVEY §2); scale-out across
hosts needs exactly one extra step: initialize the JAX distributed runtime
before building meshes, after which every sharded code path in this
package (`make_sharded_frame_fn`, `shard_ensemble`, the ppermute ring)
works unchanged — `jax.devices()` spans every host's GPUs, and the
``data`` axis of :func:`pyqmd_tpu.parallel.mesh.make_mesh` lays across the
network between hosts and NVLink within them.

Not exercisable in a single-host environment; the single-process path is a
guarded no-op so the same launcher script runs everywhere.
"""

from __future__ import annotations

import logging
import os

import jax

logger = logging.getLogger("pyqmd_tpu")

# Environment signals of a multi-process cluster (jax.distributed
# auto-detection sources: explicit JAX coordinator, SLURM, Open MPI).
# Checked WITHOUT touching any JAX backend — calling e.g.
# jax.process_count() first would initialize the local backend and break a
# subsequent jax.distributed.initialize().
_COORDINATOR_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "OMPI_MCA_orte_hnp_uri",
)


def cluster_detected() -> bool:
    """True when cluster env vars indicate a multi-*process* launch.

    Presence alone is not enough: SLURM single-node jobs export
    ``SLURM_JOB_NUM_NODES=1`` — only multi-node values count.

    Detection is ENV-ONLY by design (any JAX API here would initialize a
    backend before ``jax.distributed.initialize`` and break it). A launch
    that exports none of these passes explicit ``coordinator_address``,
    ``num_processes`` and ``process_id`` to :func:`initialize_multihost`.
    """
    if any(os.environ.get(v) for v in _COORDINATOR_ENV_VARS):
        return True
    try:
        return int(os.environ.get("SLURM_JOB_NUM_NODES", "1")) > 1
    except ValueError:
        return False


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize the distributed runtime; returns True if multi-host.

    With explicit arguments, always initializes. With no arguments, the
    decision is made from cluster environment variables alone (see
    :func:`cluster_detected`) so that ``jax.distributed.initialize`` runs
    BEFORE anything touches a backend; a plain single-process launch is a
    no-op and launchers need no special-casing.
    """
    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    if num_processes == 1 or (not explicit and not cluster_detected()):
        logger.info("single process; skipping jax.distributed.initialize")
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    logger.info(
        "distributed runtime up: process %d/%d, %d global devices",
        jax.process_index(), jax.process_count(), jax.device_count(),
    )
    return True


def local_batch_slice(global_batch: int) -> tuple[int, int]:
    """(start, size) of this host's shard of a globally-sharded ensemble —
    for building per-host inputs that `jax.make_array_from_process_local_data`
    assembles into the global array."""
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    size = global_batch // n
    return jax.process_index() * size, size
