"""Mesh/sharding tests on the 8-virtual-device CPU mesh (SURVEY §4 tier 4).

The fake-backend analog: XLA host-platform device multiplication. Checks
that the shard_map ensemble equals the unsharded vmap bit-for-bit (modulo
psum reduction order) and that the ppermute ring force (P5) matches the
dense single-device force.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.forces import force_step
from pyqmd_tpu.core.init import ensemble_init, init_state
from pyqmd_tpu.core.step import ensemble_step
from pyqmd_tpu.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    make_ring_force_step,
    make_sharded_frame_fn,
    shard_ensemble,
)


def test_make_mesh_shapes(eight_devices):
    mesh = make_mesh()
    assert mesh.axis_names == (DATA_AXIS,)
    assert mesh.devices.size == 8
    mesh2 = make_mesh((4, 2), (DATA_AXIS, MODEL_AXIS))
    assert mesh2.shape == {DATA_AXIS: 4, MODEL_AXIS: 2}
    with pytest.raises(ValueError):
        make_mesh((16,))


def test_sharded_ensemble_matches_unsharded(eight_devices):
    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    batch = 32
    states = ensemble_init(cfg, batch, seed=0)

    # Unsharded reference.
    ref_states, ref_m = jax.jit(
        lambda s: ensemble_step(s, cfg, 1.0, 1 / 60.0, 2)
    )(states)

    mesh = make_mesh()
    sharded = shard_ensemble(ensemble_init(cfg, batch, seed=0), mesh)
    fn = make_sharded_frame_fn(cfg, 2, mesh)
    out_states, m = fn(sharded, 1.0, 1 / 60.0)

    np.testing.assert_allclose(
        np.asarray(out_states.pos), np.asarray(ref_states.pos), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(m["total_decay_counts"]), np.asarray(ref_m["total_decay_counts"])
    )
    assert int(m["total_alive"]) == int(ref_m["total_alive"])
    assert int(m["survivors"]) <= batch


def test_sharded_frame_runs_many_frames(eight_devices):
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    mesh = make_mesh()
    states = shard_ensemble(ensemble_init(cfg, 16, seed=1), mesh)
    fn = make_sharded_frame_fn(cfg, 2, mesh)
    for _ in range(3):
        states, m = fn(states, 1.0, 1 / 60.0)
    assert bool(jnp.all(jnp.isfinite(states.pos)))
    assert int(m["survivors"]) == 16  # He-4 stable


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_ring_force_matches_dense(eight_devices, n_shards):
    cfg = SimConfig.for_isotope(26, 30, pad_to=8)
    st = init_state(cfg, seed=0)
    dt = 1 / 240.0

    dense_pos, dense_vel = jax.jit(
        lambda *a: force_step(*a, dt, cfg)
    )(st.pos, st.vel, st.ptype, st.alive)

    mesh = make_mesh((n_shards,), (MODEL_AXIS,), devices=jax.devices()[:n_shards])
    ring = make_ring_force_step(cfg, mesh)
    ring_pos, ring_vel = ring(st.pos, st.vel, st.ptype, st.alive, dt)

    np.testing.assert_allclose(
        np.asarray(ring_pos), np.asarray(dense_pos), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(ring_vel), np.asarray(dense_vel), rtol=1e-4, atol=1e-4
    )


def test_ring_force_multiple_steps_stay_bound(eight_devices):
    cfg = SimConfig.for_isotope(26, 30, pad_to=8)
    st = init_state(cfg, seed=2)
    mesh = make_mesh((4,), (MODEL_AXIS,), devices=jax.devices()[:4])
    ring = make_ring_force_step(cfg, mesh)
    pos, vel = st.pos, st.vel
    for _ in range(20):
        pos, vel = ring(pos, vel, st.ptype, st.alive, 1 / 240.0)
    assert bool(jnp.all(jnp.isfinite(pos)))


def test_2d_mesh_data_times_model(eight_devices):
    """2-D mesh: ensemble over 'data', ring force over 'model' — the
    composed layout the multichip dryrun exercises."""
    cfg = SimConfig.for_isotope(8, 8, pad_to=8)
    mesh = make_mesh((4, 2), (DATA_AXIS, MODEL_AXIS))
    st = init_state(cfg, seed=0)
    dt = 1 / 240.0

    ring = make_ring_force_step(cfg, mesh, axis=MODEL_AXIS)
    # vmap the model-sharded force over a data-sharded batch.
    batch = ensemble_init(cfg, 8, seed=3)
    out_pos, out_vel = jax.vmap(
        lambda p, v, t, a: ring(p, v, t, a, dt)
    )(batch.pos, batch.vel, batch.ptype, batch.alive)

    ref_pos, ref_vel = jax.vmap(
        lambda p, v, t, a: force_step(p, v, t, a, dt, cfg)
    )(batch.pos, batch.vel, batch.ptype, batch.alive)
    np.testing.assert_allclose(np.asarray(out_pos), np.asarray(ref_pos), rtol=1e-4, atol=1e-4)


def test_multihost_single_process_noop():
    from pyqmd_tpu.parallel import initialize_multihost, local_batch_slice

    assert initialize_multihost() is False  # single process: guarded no-op
    assert initialize_multihost(num_processes=1) is False
    start, size = local_batch_slice(64)
    assert (start, size) == (0, 64)  # one host owns the whole batch


def test_cluster_detection_env_gated(monkeypatch):
    """Auto-detection reads env vars only — never jax.process_count(),
    which would initialize the backend before jax.distributed (ADVICE r2)."""
    from pyqmd_tpu.parallel.multihost import cluster_detected

    for v in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "OMPI_MCA_orte_hnp_uri", "SLURM_JOB_NUM_NODES"):
        monkeypatch.delenv(v, raising=False)
    assert cluster_detected() is False
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "bogus")
    assert cluster_detected() is False  # unparsable counts as one node
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "1")
    assert cluster_detected() is False
    monkeypatch.setenv("SLURM_JOB_NUM_NODES", "4")
    assert cluster_detected() is True
    monkeypatch.delenv("SLURM_JOB_NUM_NODES")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "10.0.0.1:8476")
    assert cluster_detected() is True


def test_ring_frame_matches_dense_frame(eight_devices):
    """A COMPLETE frame (ejecta + decay + forces + overlap) with the force
    step model-sharded over the ppermute ring equals the dense frame
    (VERDICT r2 weak #5): same PRNG stream, so decays are identical and
    positions agree to collective reduction order."""
    from pyqmd_tpu.core.step import simulate_frame
    from pyqmd_tpu.parallel import make_ring_frame_fn

    cfg = SimConfig.for_isotope(92, 146, pad_to=8)  # 240 = 8 x 30
    st = init_state(cfg, seed=0)

    dense_st, dense_m = jax.jit(
        lambda s: simulate_frame(s, cfg, 3.15576e16, 1 / 60.0, 4)
    )(st)

    mesh = make_mesh((8,), (MODEL_AXIS,))
    frame = make_ring_frame_fn(cfg, 4, mesh)
    ring_st, ring_m = frame(init_state(cfg, seed=0), 3.15576e16, 1 / 60.0)

    # Decay path identical (keys don't depend on the force backend).
    assert int(ring_st.z) == int(dense_st.z)
    assert int(ring_st.chain_cursor) == int(dense_st.chain_cursor)
    np.testing.assert_array_equal(
        np.asarray(ring_st.decay_counts), np.asarray(dense_st.decay_counts)
    )
    np.testing.assert_allclose(
        np.asarray(ring_st.pos), np.asarray(dense_st.pos), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(ring_st.vel), np.asarray(dense_st.vel), rtol=1e-4, atol=1e-4
    )
    # Multi-frame: stays finite and keeps decaying under the ring.
    st2 = ring_st
    for _ in range(3):
        st2, m2 = frame(st2, 3.15576e16, 1 / 60.0)
    assert bool(jnp.all(jnp.isfinite(st2.pos)))

    with pytest.raises(ValueError):
        make_ring_frame_fn(SimConfig.for_isotope(2, 2, pad_to=4), 2, mesh)


def test_sharded_checkpoint_roundtrip(eight_devices, tmp_path):
    """Orbax save/restore of a sharded ensemble preserves the sharding and
    the trajectory continues bit-identically (VERDICT r2 item 10)."""
    from pyqmd_tpu.utils.checkpoint import (
        load_checkpoint_orbax,
        save_checkpoint_orbax,
    )

    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    mesh = make_mesh()
    states = shard_ensemble(ensemble_init(cfg, 16, seed=0), mesh)
    fn = make_sharded_frame_fn(cfg, 2, mesh)
    states, _ = fn(states, 1.0, 1 / 60.0)

    path = str(tmp_path / "sharded_ck")
    save_checkpoint_orbax(path, states, cfg)
    restored, cfg2 = load_checkpoint_orbax(path, sharding_state=states)
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(restored.pos), np.asarray(states.pos))
    # Restored state KEEPS the batch sharding over the data axis — assert
    # it rather than re-sharding (a manual shard_ensemble here would
    # silently repair a restore that dropped the sharding).
    assert restored.pos.sharding.is_equivalent_to(
        states.pos.sharding, states.pos.ndim
    ), f"restore dropped sharding: {restored.pos.sharding}"
    cont_a, _ = fn(states, 1.0, 1 / 60.0)
    cont_b, _ = fn(restored, 1.0, 1 / 60.0)
    np.testing.assert_array_equal(np.asarray(cont_a.pos), np.asarray(cont_b.pos))
    np.testing.assert_array_equal(np.asarray(cont_a.rng), np.asarray(cont_b.rng))


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_hybrid_frame_matches_dense_ensemble(eight_devices, shape):
    """Hybrid dp x sp frame (batch over 'data', force ring over 'model')
    equals the dense ensemble step: decay draws identical, positions to
    collective reduction order."""
    from pyqmd_tpu.parallel import make_hybrid_frame_fn

    data, model = shape
    cfg = SimConfig.for_isotope(92, 146, pad_to=8 * model)
    batch = 2 * data
    states = ensemble_init(cfg, batch, seed=0)
    ref_states, ref_m = jax.jit(
        lambda s: ensemble_step(s, cfg, 3.15576e16, 1 / 60.0, 2)
    )(states)

    mesh = make_mesh(shape, (DATA_AXIS, MODEL_AXIS))
    fn = make_hybrid_frame_fn(cfg, 2, mesh)
    out_states, m = fn(ensemble_init(cfg, batch, seed=0), 3.15576e16, 1 / 60.0)

    np.testing.assert_array_equal(
        np.asarray(out_states.z), np.asarray(ref_states.z)
    )
    np.testing.assert_array_equal(
        np.asarray(m["total_decay_counts"]), np.asarray(ref_m["total_decay_counts"])
    )
    np.testing.assert_allclose(
        np.asarray(out_states.pos), np.asarray(ref_states.pos),
        rtol=1e-4, atol=1e-4,
    )
    assert int(m["total_alive"]) == int(ref_m["total_alive"])

    with pytest.raises(ValueError):
        # pad_to=5 -> capacity 5, indivisible by any model size >= 2
        make_hybrid_frame_fn(SimConfig.for_isotope(2, 2, pad_to=5), 2, mesh)


def test_sharded_run_matches_frame_loop(eight_devices):
    """Fused sharded run == the per-frame sharded loop (same PRNG path)."""
    from pyqmd_tpu.parallel import make_sharded_run_fn

    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    mesh = make_mesh()
    batch = 16
    a = shard_ensemble(ensemble_init(cfg, batch, seed=0), mesh)
    frame = make_sharded_frame_fn(cfg, 2, mesh)
    for _ in range(3):
        a, ma = frame(a, 3.15576e16, 1 / 60.0)

    b = shard_ensemble(ensemble_init(cfg, batch, seed=0), mesh)
    run = make_sharded_run_fn(cfg, 2, 3, mesh)
    b, mb = run(b, 3.15576e16, 1 / 60.0)

    np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))
    np.testing.assert_allclose(
        np.asarray(a.pos), np.asarray(b.pos), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(ma["total_decay_counts"]), np.asarray(mb["total_decay_counts"])
    )
    assert int(ma["survivors"]) == int(mb["survivors"])


def test_sharded_decay_frame_matches_unsharded(eight_devices):
    """Sharded decay-only frame: isotope trajectories and psum'd
    aggregates bitwise-match the unsharded decay_ensemble_step."""
    from pyqmd_tpu.core.step import decay_ensemble_step
    from pyqmd_tpu.parallel import make_sharded_decay_fn, shard_ensemble
    from pyqmd_tpu.parallel.mesh import make_mesh

    cfg = SimConfig.for_isotope(82, 132, pad_to=8)  # Pb-214: events happen
    batch = 32
    states = ensemble_init(cfg, batch, seed=0)
    ref_states, ref_m = jax.jit(
        lambda s: decay_ensemble_step(s, cfg, 400.0, 1.0, 4)
    )(states)

    mesh = make_mesh()
    sharded = shard_ensemble(ensemble_init(cfg, batch, seed=0), mesh)
    fn = make_sharded_decay_fn(cfg, 4, mesh)
    out_states, m = fn(sharded, 400.0, 1.0)

    for fld in ("z", "n", "half_life", "decay_counts", "rng"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out_states, fld)),
            np.asarray(getattr(ref_states, fld)),
        )
    np.testing.assert_array_equal(
        np.asarray(m["total_decay_counts"]), np.asarray(ref_m["total_decay_counts"])
    )
    assert int(m["survivors"]) == int(
        np.asarray((ref_m["z"] == 82) & (ref_m["n"] == 132)).sum()
    )


def test_ring_force_leapfrog_matches_dense(eight_devices):
    """integrator='leapfrog' runs two ring sweeps per step (CoM re-psum'd
    at the drifted positions) and matches the dense velocity-Verlet step —
    the ring path no longer silently falls back to Euler (r4)."""
    cfg = SimConfig.for_isotope(26, 30, pad_to=8, integrator="leapfrog")
    st = init_state(cfg, seed=0)
    dt = 1 / 240.0

    dense_pos, dense_vel = jax.jit(
        lambda *a: force_step(*a, dt, cfg)
    )(st.pos, st.vel, st.ptype, st.alive)

    mesh = make_mesh((4,), (MODEL_AXIS,), devices=jax.devices()[:4])
    ring = make_ring_force_step(cfg, mesh)
    ring_pos, ring_vel = ring(st.pos, st.vel, st.ptype, st.alive, dt)

    np.testing.assert_allclose(
        np.asarray(ring_pos), np.asarray(dense_pos), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(ring_vel), np.asarray(dense_vel), rtol=1e-4, atol=1e-4
    )
