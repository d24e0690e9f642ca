"""Fused force kernel and overlap pass equivalence tests (SURVEY §4 tier 2).

The Triton-route kernel must match the jnp oracle to f32 tolerance across
nucleus sizes, batch shapes and block layouts. On the CPU it runs in
interpret mode; tests/test_chip.py and chip_smoke.py run the same
comparison compiled on the GPU. The overlap pass (plain jnp on every
device) is pinned against a float64 NumPy statement of the same Jacobi
projection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.forces import force_step
from pyqmd_tpu.kernels.forces_pallas import (
    TILE_ELEMS,
    _force_step_batched,
    block_layout,
    force_step_pallas,
)

CFG = SimConfig.for_isotope(92, 146, pad_to=128)


def _random_state(p, n_alive, seed, spread=40.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(400 - spread / 2, 400 + spread / 2, (p, 2)).astype(np.float32)
    vel = rng.normal(0, 2, (p, 2)).astype(np.float32)
    ptype = rng.integers(0, 2, p).astype(np.int32)
    alive = np.arange(p) < n_alive
    return (
        jnp.asarray(pos),
        jnp.asarray(vel),
        jnp.asarray(ptype),
        jnp.asarray(alive),
    )


def _stack(states):
    return tuple(jnp.stack([s[k] for s in states]) for k in range(4))


@pytest.mark.parametrize("n_alive", [4, 56, 238, 256])
def test_kernel_matches_jnp(n_alive):
    pos, vel, ptype, alive = _random_state(256, n_alive, n_alive)
    dt = 1 / 240.0
    jp, jv = force_step(pos, vel, ptype, alive, dt, CFG)
    pp, pv = force_step_pallas(pos, vel, ptype, alive, dt, CFG, interpret=True)
    np.testing.assert_allclose(np.asarray(pp), np.asarray(jp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(pv), np.asarray(jv), rtol=1e-4, atol=1e-4)


def test_kernel_batched_and_group_padding():
    """Batches that don't fill the last program's group of nuclei are
    padded with dead nuclei and unpadded."""
    _, _, group = block_layout(8, 1 << 20)
    assert group > 1
    b = group + 3
    states = [_random_state(8, 6, s, spread=12.0) for s in range(b)]
    dt = 1 / 240.0

    pp, pv = force_step_pallas(*_stack(states), dt, CFG, interpret=True)
    for i in range(b):
        rp, rv = force_step(*states[i], dt, CFG)
        np.testing.assert_allclose(
            np.asarray(pp[i]), np.asarray(rp), rtol=1e-4, atol=1e-4
        )
        # Velocities too: padded-row garbage would corrupt v before it
        # shows in x after a single dt step.
        np.testing.assert_allclose(
            np.asarray(pv[i]), np.asarray(rv), rtol=1e-4, atol=1e-4
        )


def test_kernel_dense_cluster():
    """Hard-core regime: everything overlapping (post-init state)."""
    pos, vel, ptype, alive = _random_state(128, 64, 7, spread=4.0)
    dt = 1 / 240.0
    jp, jv = force_step(pos, vel, ptype, alive, dt, CFG)
    pp, pv = force_step_pallas(pos, vel, ptype, alive, dt, CFG, interpret=True)
    np.testing.assert_allclose(np.asarray(pp), np.asarray(jp), rtol=2e-4, atol=2e-4)


def test_kernel_unaligned_capacity_pads():
    """P=100 pads to the next power of two (128) with dead slots."""
    pos, vel, ptype, alive = _random_state(100, 50, 0)
    dt = 1 / 240.0
    jp, jv = force_step(pos, vel, ptype, alive, dt, CFG)
    pp, pv = force_step_pallas(pos, vel, ptype, alive, dt, CFG, interpret=True)
    assert pp.shape == pos.shape
    np.testing.assert_allclose(np.asarray(pp), np.asarray(jp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(pv), np.asarray(jv), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p,batch", [(8, 1), (8, 37), (16, 19), (6, 21)])
def test_kernel_grouped_small_nuclei(p, batch):
    """Small capacities put several nuclei in one program, each with its
    own pair block and center of mass. Mixed alive counts and batches that
    straddle group boundaries must match the per-nucleus jnp oracle."""
    cfg = SimConfig.for_isotope(2, 2, pad_to=p)
    rng = np.random.default_rng(p * 100 + batch)
    dt = 1 / 240.0
    states = []
    for i in range(batch):
        # Varying alive counts, including fully-dead members.
        n_alive = int(rng.integers(0, p + 1))
        states.append(_random_state(p, n_alive, seed=i, spread=12.0))

    pp, pv = force_step_pallas(*_stack(states), dt, cfg, interpret=True)
    assert pp.shape == (batch, p, 2)
    for i in range(batch):
        jp, jv = force_step(*states[i], dt, cfg)
        np.testing.assert_allclose(
            np.asarray(pp[i]), np.asarray(jp), rtol=1e-4, atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(pv[i]), np.asarray(jv), rtol=1e-4, atol=1e-4
        )


def test_kernel_grouped_nuclei_independent():
    """Nuclei sharing a program must not interact: a group computes the
    same forces as each nucleus alone."""
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    dt = 1 / 240.0
    _, _, group = block_layout(8, 1 << 20)
    assert group > 1
    # Every nucleus clustered at the SAME world position — cross-nucleus
    # pairs would be inside every force range if the blocks leaked.
    states = [_random_state(8, 8, seed=i, spread=6.0) for i in range(group)]
    pp, pv = force_step_pallas(*_stack(states), dt, cfg, interpret=True)
    for i in range(group):
        sp, sv = force_step_pallas(*states[i], dt, cfg, interpret=True)
        np.testing.assert_allclose(np.asarray(pp[i]), np.asarray(sp), rtol=0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(pv[i]), np.asarray(sv), rtol=0, atol=1e-5)


@pytest.mark.parametrize("p,n_alive", [(256, 238), (8, 4)])
def test_kernel_leapfrog_matches_jnp(p, n_alive):
    """The leapfrog (velocity-Verlet) integrator runs as two kernel calls
    (kick-drift, then kick) and matches core.forces._leapfrog_step."""
    cfg = SimConfig.for_isotope(92, 146, pad_to=p, integrator="leapfrog")
    pos, vel, ptype, alive = _random_state(p, n_alive, seed=p)
    dt = 1 / 240.0
    jp, jv = force_step(pos, vel, ptype, alive, dt, cfg)
    pp, pv = force_step_pallas(pos, vel, ptype, alive, dt, cfg, interpret=True)
    np.testing.assert_allclose(np.asarray(pp), np.asarray(jp), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(pv), np.asarray(jv), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_kernel_lowers_to_triton_for_cuda(integrator):
    """The kernel names its route: lowering for CUDA (no GPU needed)
    yields Triton calls, one per sweep, and no other kernel route."""
    cfg = SimConfig.for_isotope(92, 146, pad_to=128, integrator=integrator)
    pos, vel, ptype, alive = _random_state(256, 238, 0)
    fn = jax.jit(lambda *a: force_step_pallas(*a, 1 / 240.0, cfg))
    text = fn.trace(pos[None], vel[None], ptype[None], alive[None]).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    calls = text.count("stablehlo.custom_call @__gpu$xla.gpu.triton")
    assert calls == (2 if integrator == "leapfrog" else 1)
    assert "mosaic" not in text.lower()


def test_block_layout_math():
    """Capacity -> (padded capacity, partner block, nuclei per program)."""
    t = TILE_ELEMS
    for p in (1, 2, 6, 8, 14, 16, 100, 128, 200, 256, 4096):
        p2, bj, group = block_layout(p, 1 << 20)
        assert p2 >= p and p2 & (p2 - 1) == 0  # next power of two
        assert p2 < 2 * p or p == 1
        assert bj & (bj - 1) == 0 and group & (group - 1) == 0
        assert p2 % bj == 0  # the partner loop covers every slot
        assert group * p2 * bj <= max(t, p2)  # one tile, or one row block
        if p2 * p2 <= t:  # small nuclei: whole pair block per nucleus
            assert bj == p2 and group == t // (p2 * p2)
        else:
            assert group == 1
    # A single nucleus is never padded to a group.
    assert block_layout(8, 1)[2] == 1
    assert block_layout(8, 3)[2] == 4


@pytest.mark.parametrize("tile", [256, 1024, 4096])
def test_tile_override_equivalence(tile):
    """The tile size changes only the block layout, not the numbers."""
    from pyqmd_tpu.core.init import ensemble_init

    cfg = SimConfig.for_isotope(2, 2, pad_to=8, force_backend="pallas")
    states = ensemble_init(cfg, 64, seed=3)
    dt = cfg.effective_dt()
    args = (states.pos, states.vel, states.ptype, states.alive)
    p0, v0 = _force_step_batched(*args, dt, cfg, interpret=True)
    p1, v1 = _force_step_batched(*args, dt, cfg, interpret=True, tile_elems=tile)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v0), rtol=0, atol=1e-5)


# --- overlap pass (core/overlap.py) vs a float64 NumPy statement ------------


def _overlap_numpy(pos, alive, u, cfg):
    """The capped Jacobi projection of core.overlap, pair by pair in
    float64 (nuclear_sim.py:355-379 semantics)."""
    pos = np.asarray(pos, np.float64)
    alive = np.asarray(alive)
    u = np.asarray(u, np.float64)
    md = cfg.overlap_min_dist
    out = pos.copy()
    for i in np.flatnonzero(alive):
        delta = np.zeros(2)
        for j in np.flatnonzero(alive):
            if i == j:
                continue
            d = pos[j] - pos[i]
            dist = np.sqrt(max(d @ d, 1e-12))
            if dist * dist >= md * md:
                continue
            if dist < 0.001:
                sign = 1.0 if i < j else -1.0
                direction = sign * np.array([np.cos(u[i] + u[j]), np.sin(u[i] + u[j])])
                push = (md - 0.001) * 0.5
            else:
                direction = d / dist
                push = (md - dist) * 0.5
            delta -= direction * push
        mag = np.linalg.norm(delta)
        out[i] = pos[i] + delta * min(1.0, md * 0.5 / max(mag, 1e-9))
    return out


@pytest.mark.parametrize("n_alive", [4, 100, 238, 256])
def test_overlap_matches_numpy(n_alive):
    from pyqmd_tpu.core.overlap import _resolve_once

    rng = np.random.default_rng(n_alive)
    p = 256
    # Tight cluster so plenty of pairs are inside overlap_min_dist.
    pos = rng.uniform(395, 405, (p, 2)).astype(np.float32)
    alive = np.arange(p) < n_alive
    u = rng.uniform(0, 2 * np.pi, p).astype(np.float32)
    out = _resolve_once(jnp.asarray(pos), jnp.asarray(alive), jnp.asarray(u), CFG)
    ref = _overlap_numpy(pos, alive, u, CFG)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=1e-3)
    # Dead slots never move.
    np.testing.assert_array_equal(np.asarray(out)[~alive], pos[~alive])


def test_overlap_degenerate_pairs():
    """Coincident particles separate along the angle-sum direction
    (nuclear_sim.py:367-369 analog), the two sides pushed oppositely."""
    from pyqmd_tpu.core.overlap import _resolve_once

    p = 128
    pos = np.broadcast_to(np.array([400.0, 400.0], np.float32), (p, 2)).copy()
    alive = np.arange(p) < 3  # three coincident nucleons
    u = np.linspace(0.1, 6.0, p).astype(np.float32)
    cfg = SimConfig.for_isotope(2, 2, pad_to=128)
    out = _resolve_once(jnp.asarray(pos), jnp.asarray(alive), jnp.asarray(u), cfg)
    ref = _overlap_numpy(pos, alive, u, cfg)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0, atol=1e-3)
    # They actually separated.
    d01 = float(jnp.linalg.norm(out[0] - out[1]))
    assert d01 > 1.0


def test_overlap_chunked_batch():
    """_batched_overlap's lax.map chunking (with an all-dead pad) gives
    each member the single-nucleus result."""
    from pyqmd_tpu.core.overlap import resolve_overlaps
    from pyqmd_tpu.core.step import _batched_overlap

    rng = np.random.default_rng(7)
    b, p = 11, 64
    pos = jnp.asarray(rng.uniform(395, 405, (b, p, 2)).astype(np.float32))
    alive = jnp.asarray(rng.uniform(size=(b, p)) < 0.8)
    keys = jax.vmap(jax.random.key)(jnp.arange(b, dtype=jnp.uint32))
    cfg = SimConfig.for_isotope(26, 30, pad_to=64)
    out = _batched_overlap(pos, alive, keys, cfg, max_chunk=4)  # 3 chunks, pad 1
    for i in range(b):
        ref = resolve_overlaps(pos[i], alive[i], keys[i], cfg)
        # Float32 spacing at |x| ~ 400 is 3.05e-5: batched and single
        # evaluation may round one coordinate differently.
        np.testing.assert_allclose(
            np.asarray(out[i]), np.asarray(ref), rtol=0, atol=1e-4
        )
