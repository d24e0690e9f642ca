"""Sharded ensemble stepping: P1 (data parallelism) + P3 (cross-chip stats).

The ensemble is a vmapped batch of independent nuclei; sharding it over the
``data`` mesh axis with ``shard_map`` gives each device its local shard of
the O(N^2) work, and aggregate decay statistics are ``psum``'d across devices so
the host reads O(1) numbers regardless of ensemble size. The reference has
no equivalent — one nucleus per process (nuclear_sim.py:48, 92-93).

The shard_map scaffolding (out_specs built from ``METRIC_KEYS`` /
``AGGREGATE_METRIC_KEYS``, psum'd aggregates) is shared by every sharded
frame builder here and in :mod:`pyqmd_tpu.parallel.hybrid` via
:func:`psum_aggregates` and :func:`make_sharded_caller` — one site to
touch when a metric is added.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.step import (
    AGGREGATE_METRIC_KEYS,
    METRIC_KEYS,
    decay_ensemble_step,
    ensemble_step,
    state_metrics,
)
from pyqmd_tpu.parallel.mesh import DATA_AXIS


def psum_aggregates(metrics: dict, cfg: SimConfig, axis: str) -> dict:
    """Attach the cross-shard aggregates to per-shard metrics: psum'd decay
    counts and alive totals, plus ``survivors`` (nuclei still in their
    initial isotope — the half-life statistics numerator)."""
    if "total_decay_counts" not in metrics:  # raw state_metrics output
        metrics["total_decay_counts"] = jnp.sum(metrics["decay_counts"], axis=0)
        metrics["total_alive"] = jnp.sum(metrics["alive"])
    metrics["total_decay_counts"] = jax.lax.psum(
        metrics["total_decay_counts"], axis
    )
    metrics["total_alive"] = jax.lax.psum(metrics["total_alive"], axis)
    metrics["survivors"] = jax.lax.psum(
        jnp.sum(
            ((metrics["z"] == cfg.z) & (metrics["n"] == cfg.n)).astype(jnp.int32)
        ),
        axis,
    )
    return metrics


def make_sharded_caller(local_fn, mesh, axis: str):
    """Wrap a ``local_fn(states, time_scale, frame_dt)`` in the standard
    sharded-frame plumbing: batch sharded over ``axis``, metric out_specs
    derived from the canonical key lists, scalars cast, input donated."""
    state_spec = P(axis)
    metric_specs = {k: state_spec for k in METRIC_KEYS}
    metric_specs.update({k: P() for k in AGGREGATE_METRIC_KEYS})
    shard = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(state_spec, P(), P()),
        out_specs=(state_spec, metric_specs),
        check_vma=False,
    )

    @functools.partial(jax.jit, donate_argnums=(0,))
    def call(states, time_scale, frame_dt):
        return shard(
            states,
            jnp.asarray(time_scale, jnp.float32),
            jnp.asarray(frame_dt, jnp.float32),
        )

    return call


def _make_sharded_step_fn(step_fn, cfg: SimConfig, num_steps: int, mesh, axis: str):
    """Shared builder: one sharded frame around any batched step function
    (full physics or decay-only) — the single place the per-frame
    psum-aggregation wrapping lives."""

    def local_frame(states, time_scale, frame_dt):
        new_states, metrics = step_fn(states, cfg, time_scale, frame_dt, num_steps)
        return new_states, psum_aggregates(metrics, cfg, axis)

    return make_sharded_caller(local_frame, mesh, axis)


def make_sharded_frame_fn(cfg: SimConfig, num_steps: int, mesh, axis: str = DATA_AXIS):
    """Jit-compiled sharded ensemble frame.

    Returns ``fn(states, time_scale, frame_dt) -> (states, metrics)`` where
    ``states`` has a leading batch axis divisible by the mesh ``axis`` size.
    Per-nucleus metrics stay sharded with the batch; ``total_decay_counts``
    and ``total_alive`` / ``survivors`` are psum'd across devices.
    """
    return _make_sharded_step_fn(ensemble_step, cfg, num_steps, mesh, axis)


def make_sharded_decay_fn(
    cfg: SimConfig, num_steps: int, mesh, axis: str = DATA_AXIS
):
    """Sharded decay-only frame: the multi-chip form of
    :func:`pyqmd_tpu.core.step.decay_ensemble_step` — pure decay
    statistics (no forces/ejecta/overlap) over the ``data`` axis with
    psum'd aggregates. Isotope trajectories are bitwise identical to the
    sharded full-physics frame, so multi-device half-life measurements
    (N × 2M nuclei) cost O(B·P) per substep per chip."""
    return _make_sharded_step_fn(decay_ensemble_step, cfg, num_steps, mesh, axis)


def make_sharded_run_fn(
    cfg: SimConfig, num_steps: int, num_frames: int, mesh, axis: str = DATA_AXIS
):
    """Fused sharded run: ``num_frames`` whole frames scanned inside ONE
    sharded dispatch — the multi-chip analog of
    :func:`pyqmd_tpu.core.step.make_run_fn` for throughput/statistics
    workloads with a constant time scale. Returns the final state and the
    last frame's metrics (aggregates psum'd over ``axis``)."""

    def local_run(states, time_scale, frame_dt):
        def body(st, _):
            st, _m = ensemble_step(st, cfg, time_scale, frame_dt, num_steps)
            return st, None

        states, _ = jax.lax.scan(body, states, None, length=num_frames)
        return states, psum_aggregates(state_metrics(states), cfg, axis)

    return make_sharded_caller(local_run, mesh, axis)


def survival_fraction(metrics, cfg: SimConfig, batch: int):
    """Fraction of the ensemble still in the initial isotope."""
    return metrics["survivors"] / batch
