"""Nucleus initialization: magic-number shell placement.

Behavioral port of the reference initializer
(/root/reference/particles.py:62-124): nucleons are placed on shells with
capacities [2, 8, 20, 28, 50, 82, 126] inside radius
``1.2 * A^(1/3) * 0.7``, alternating proton/neutron pairs per shell then
remainders, each placement choosing the best of 20 random angles by
maximizing the minimum distance to already-placed same-type nucleons.

Accelerator-first departures: the placement *order* (which shell, which type, per
particle index) is a pure function of (Z, N) computed once on host as a
static array; the sequential best-of-20 search runs as a ``lax.fori_loop``
whose candidate scoring is a vectorized (20, P) distance computation — and
the whole initializer vmaps over an ensemble batch of PRNG keys.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.data import tables
from pyqmd_tpu.state import DECAY_NONE, NEUTRON, PROTON, NucleusState, empty_state

SHELL_CAPACITY = (2, 8, 20, 28, 50, 82, 126)


def placement_order(z: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Static placement plan: (shell_index, is_proton) per particle index.

    Mirrors the shell-filling loop at particles.py:105-124: proton/neutron
    pairs per shell up to half the shell capacity, shell index advancing and
    clamping at the last shell, then proton remainders, then neutron
    remainders.
    """
    last = len(SHELL_CAPACITY) - 1
    order: list[tuple[int, bool]] = []
    pp = pn = 0
    si = 0
    while pp < z and pn < n:
        size = SHELL_CAPACITY[min(si, last)]
        pairs = min(size // 2, min(z - pp, n - pn))
        for _ in range(pairs):
            order.append((min(si, last), True))
            pp += 1
            order.append((min(si, last), False))
            pn += 1
        si += 1
        if si > last:
            si = last
    while pp < z:
        order.append((min(si, last), True))
        pp += 1
    while pn < n:
        order.append((min(si, last), False))
        pn += 1
    shell_idx = np.array([s for s, _ in order], np.int32)
    is_proton = np.array([p for _, p in order], bool)
    return shell_idx, is_proton


def _place_shells(cfg: SimConfig, place_key: jax.Array) -> jax.Array:
    """Sequential best-of-20 shell placement; returns (P, 2) positions
    (particles.py:62-124 behavior, vectorized candidate scoring)."""
    a = cfg.z + cfg.n
    p = cfg.max_particles
    shell_idx, is_proton = placement_order(cfg.z, cfg.n)
    # Shell radii (particles.py:64-68): A^(1/3) scaling, 7 evenly spaced shells.
    nuclear_radius = 1.2 * a ** (1.0 / 3.0)
    initial_radius = nuclear_radius * 0.7
    n_shells = len(SHELL_CAPACITY)
    shell_radii = initial_radius * (np.arange(n_shells) + 1) / n_shells
    base_radius = jnp.asarray(
        np.pad(shell_radii[shell_idx].astype(np.float32), (0, p - a))
    )
    ptype = jnp.asarray(
        np.pad(np.where(is_proton, PROTON, NEUTRON).astype(np.int32), (0, p - a))
    )
    origin = jnp.array([cfg.origin_x, cfg.origin_y], jnp.float32)
    slot = jnp.arange(p)

    def place_one(i, carry):
        pos, k = carry
        k, kr, ka = jax.random.split(k, 3)
        # Radius jitter 0.8-1.0x the shell radius (particles.py:75).
        radius = base_radius[i] * (0.8 + 0.2 * jax.random.uniform(kr))
        angles = jax.random.uniform(ka, (20,), maxval=2.0 * jnp.pi)
        cand = origin[None, :] + radius * jnp.stack(
            [jnp.cos(angles), jnp.sin(angles)], axis=-1
        )  # (20, 2)
        # Min distance to already-placed same-type nucleons (particles.py:84-93).
        same = (ptype == ptype[i]) & (slot < i)
        d = jnp.linalg.norm(cand[:, None, :] - pos[None, :, :], axis=-1)
        dmin = jnp.min(jnp.where(same[None, :], d, jnp.inf), axis=1)
        # Best-of-20 argmax; when no same-type nucleon exists yet the
        # reference's `min_dist == inf` check makes the *last* candidate win
        # (particles.py:91-93) — replicate that tie behavior.
        sel = jnp.where(jnp.all(jnp.isinf(dmin)), 19, jnp.argmax(dmin))
        return pos.at[i].set(cand[sel]), k

    pos0 = jnp.broadcast_to(origin, (p, 2))
    pos, _ = jax.lax.fori_loop(0, a, place_one, (pos0, place_key))
    return pos


def _init_from_key(cfg: SimConfig, key: jax.Array) -> NucleusState:
    """Full exact init: member identity + sequential shell placement.
    Key split indices match :func:`_member_identity` so the pool method's
    identity draws are identical to the exact method's."""
    if cfg.z + cfg.n > cfg.max_particles:
        raise ValueError(
            f"A={cfg.z + cfg.n} exceeds max_particles={cfg.max_particles}"
        )
    place_key = jax.random.split(key, 4)[1]
    st = _member_identity(cfg, key)
    return st.replace(pos=_place_shells(cfg, place_key))


def init_state(cfg: SimConfig, seed: int = 0, key: jax.Array | None = None) -> NucleusState:
    """Build one initialized nucleus (U-238 by default, nuclear_sim.py:90)."""
    if key is None:
        key = jax.random.PRNGKey(seed)
    return _init_from_key(cfg, key)


def ensemble_init(
    cfg: SimConfig,
    batch: int,
    seed: int = 0,
    method: str = "auto",
    pool: int = 256,
) -> NucleusState:
    """Build a batch of independently-seeded nuclei: the P1 ensemble axis.

    The reference supports exactly one nucleus per process
    (nuclear_sim.py:48, 92-93); here the ensemble is a vmapped leading axis
    ready to shard over a device mesh.

    ``method``:
      * ``"exact"`` — every member runs the full sequential best-of-20
        shell placement (particles.py:62-124). The placement loop is A
        sequential steps that vectorize over the batch but not over the
        loop, so a 64k U-238 ensemble costs ~30 s.
      * ``"pool"`` — ``pool`` exact placements are built once, then each
        member samples one and applies an independent random rotation
        about the nucleus origin (the shell construction is rotationally
        symmetric, so a rotated placement is exactly as probable as any
        direct draw). ~100x faster at 64k; members share at most ``pool``
        base geometries up to rotation (docs/PARITY.md departure).
      * ``"auto"`` — exact when ``batch <= pool``, else pool.

    Either way every member gets an independent PRNG stream and half-life
    draw, so decay statistics are unaffected by the method.
    """
    if method == "auto":
        method = "exact" if batch <= pool else "pool"
    keys = jax.random.split(jax.random.PRNGKey(seed), batch)
    if method == "exact":
        return jax.vmap(lambda k: _init_from_key(cfg, k))(keys)
    if method != "pool":
        raise ValueError(f"unknown init method {method!r}")

    pool_n = min(pool, batch)
    # Fold the pool keys off the member keys' space (seed+1 stream) so pool
    # geometry is independent of per-member draws.
    pool_keys = jax.random.split(jax.random.PRNGKey(seed + 1), pool_n)
    pool_states = jax.vmap(lambda k: _init_from_key(cfg, k))(pool_keys)
    pool_pos = pool_states.pos  # (pool_n, P, 2)
    origin = jnp.array([cfg.origin_x, cfg.origin_y], jnp.float32)

    def member(key: jax.Array) -> NucleusState:
        k_sel, k_rot, k_member = jax.random.split(key, 3)
        i = jax.random.randint(k_sel, (), 0, pool_n)
        theta = jax.random.uniform(k_rot, maxval=2.0 * jnp.pi)
        c, s = jnp.cos(theta), jnp.sin(theta)
        rel = pool_pos[i] - origin
        rot = jnp.stack(
            [rel[:, 0] * c - rel[:, 1] * s, rel[:, 0] * s + rel[:, 1] * c],
            axis=-1,
        )
        st = _member_identity(cfg, k_member)
        return st.replace(pos=jnp.where(st.alive[:, None], origin + rot, origin))

    return jax.vmap(member)(keys)


def _member_identity(cfg: SimConfig, key: jax.Array) -> NucleusState:
    """Everything of a fresh member except the placement geometry: types,
    alive mask, (Z, N), per-member half-life draw, RNG stream, chain seed —
    the tail of :func:`_init_from_key` without the placement loop."""
    a = cfg.z + cfg.n
    p = cfg.max_particles
    _, is_proton = placement_order(cfg.z, cfg.n)
    ptype = jnp.asarray(
        np.pad(np.where(is_proton, PROTON, NEUTRON).astype(np.int32), (0, p - a))
    )
    slot = jnp.arange(p)
    _, _, hl_key, state_key = jax.random.split(key, 4)
    st = empty_state(cfg)
    hl = tables.half_life(
        jnp.asarray(cfg.z), jnp.asarray(cfg.n), jax.random.uniform(hl_key)
    )
    return st.replace(
        ptype=ptype,
        alive=slot < a,
        z=jnp.asarray(cfg.z, jnp.int32),
        n=jnp.asarray(cfg.n, jnp.int32),
        half_life=hl,
        rng=jax.random.key_data(state_key).astype(jnp.uint32),
        chain_z0=st.chain_z0.at[0].set(cfg.z),
        chain_n0=st.chain_n0.at[0].set(cfg.n),
        chain_dtype=st.chain_dtype.at[0].set(DECAY_NONE),
        chain_z1=st.chain_z1.at[0].set(cfg.z),
        chain_n1=st.chain_n1.at[0].set(cfg.n),
        chain_cursor=jnp.asarray(1, jnp.int32),
    )


def mixed_ensemble_init(
    cfg: SimConfig, species: list[tuple[int, int, int]], seed: int = 0
) -> NucleusState:
    """Build a mixed-population ensemble: ``species`` is a list of
    ``(Z, N, count)``. All physics downstream reads per-nucleus (Z, N) from
    the state, so a single batch can hold different isotopes — e.g. a
    U-238 + C-14 sample decaying side by side (no reference equivalent).

    Every species shares ``cfg.max_particles`` padding; the heaviest must
    fit. Sub-batches are initialized per species and concatenated.
    """
    import dataclasses

    parts = []
    for i, (z, n, count) in enumerate(species):
        if z + n > cfg.max_particles:
            raise ValueError(
                f"species ({z},{n}) A={z + n} exceeds max_particles="
                f"{cfg.max_particles}"
            )
        # Only (Z, N) varies per species: every other field of the
        # caller's cfg (capacities, origin, force constants, ...) must
        # carry through, both so the sub-states share the caller's array
        # shapes (max_ejecta/max_chain_log size state leaves) and so
        # physics overrides apply to the whole mixture.
        sub_cfg = dataclasses.replace(cfg, z=z, n=n)
        parts.append(ensemble_init(sub_cfg, count, seed=seed + i * 1_000_003))
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *parts)
