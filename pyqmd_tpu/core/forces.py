"""Pairwise nuclear force + integration: the reference-physics compute core.

Physics identical to the reference's OpenCL kernel
(/root/reference/nuclear_forces.py:60-172) and its CPU twin (:236-323):

  * hard-core repulsion inside 1.7 x nucleon radius (:102-106)
  * piecewise strong force: repulsive core < 2.8, attractive 2.8-9.0 as
    1.25*S*exp(-r/7)/(r+eps), exponential tail > 9.0 (:108-121)
  * Coulomb repulsion between proton pairs, -C/(r^2+eps) (:124-126)
  * Pauli exclusion between same-type pairs within range 8 (:129-134)
  * per-pair net-force clamp to +/-12 (:137)
  * center-of-mass containment spring outside 1.5x the nuclear radius
    R = 1.2 * A^(1/3) * 2 (:144-154)
  * semi-implicit Euler with velocity damping 0.85 (:156-171)

The architecture is not a translation: instead of one OpenCL work-item per
particle with host<->device marshaling every substep
(nuclear_forces.py:190-234), the whole pair interaction is a masked (P, P)
broadcast that XLA fuses into one program, state stays device-resident, and
an ensemble is a leading vmap axis. A fused GPU kernel with the same
semantics lives in :mod:`pyqmd_tpu.kernels.forces_pallas`; this jnp version
runs on any device and is the equivalence oracle.

One deliberate semantic note: the reference kernel reads ``particles[j]``
while work-item j may already have written its slot — a tolerated data race
making results depend on execution order (SURVEY §5). Here every read is
from the pre-step state, so the step is deterministic by construction.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.state import PROTON


def pair_net_force(dist, dist2, is_pp, is_same, cfg: SimConfig):
    """Scalar radial force magnitude for one pair at distance ``dist``.

    Positive = attractive (toward the partner). Works elementwise on arrays;
    matches nuclear_forces.py:100-137 term for term.
    """
    eps = cfg.epsilon
    s = cfg.strong_strength

    # Hard-core repulsion. x**1.5 as x*sqrt(x) (cheaper than a pow lowering).
    min_allowed = cfg.nucleon_radius * cfg.hard_core_scale
    overlap = jnp.maximum(min_allowed - dist, 0.0) / min_allowed
    f = -cfg.hard_core_strength * overlap * jnp.sqrt(overlap)

    # Piecewise strong force. The attract and tail branches share one exp by
    # selecting the exponent scale first: exp(-r) vs exp(-1.8r) — halves the
    # kernel's dominant transcendental count with bitwise-identical results.
    r_ratio = dist / cfg.strong_range
    in_attract = dist < cfg.strong_attract_cut
    amp = jnp.where(in_attract, 1.25 * s, 0.15 * s)
    k = jnp.where(in_attract, 1.0, 1.8)
    outer = amp * jnp.exp(-r_ratio * k) / (dist + eps)
    core = -0.7 * s / (dist2 + eps)
    f = f + jnp.where(dist < cfg.strong_core_cut, core, outer)

    # Coulomb repulsion, proton-proton only.
    f = f - jnp.where(is_pp, cfg.coulomb_strength / (dist2 + eps), 0.0)

    # Pauli exclusion, same-type pairs within range.
    pauli = cfg.pauli_strength * jnp.exp(-dist / cfg.pauli_range * 2.0)
    f = f - jnp.where(is_same & (dist < cfg.pauli_range), pauli, 0.0)

    return jnp.clip(f, -cfg.max_pair_force, cfg.max_pair_force)


def com_force(pos, center, count, cfg: SimConfig):
    """Center-of-mass containment spring (nuclear_forces.py:144-154).

    ``count`` is the alive nucleon count (the kernel's ``num_particles``).
    Returns a (P, 2) force contribution.
    """
    cd = center[None, :] - pos
    cdist = jnp.sqrt(jnp.sum(cd * cd, axis=-1))
    nuclear_radius = 1.2 * count ** (1.0 / 3.0) * 2.0
    active = (cdist > nuclear_radius * 1.5) & (cdist > 0.01)
    mag = cfg.com_spring * (cdist - nuclear_radius)
    scale = jnp.where(active, mag / jnp.maximum(cdist, 1e-9), 0.0)
    return cd * scale[:, None]


def pair_forces_block(pos_i, type_i, alive_i, pos_j, type_j, alive_j, cfg: SimConfig):
    """Pair-force contribution of a j-block on an i-block: (Ni, 2).

    Self-pairs and degenerate pairs are excluded by the kernel's
    ``dist2 < 0.01`` guard (nuclear_forces.py:96): a particle against
    itself has dist2 == 0 exactly. This makes the function directly usable
    as the ring-rotation body of the particle-axis sharded force
    (SURVEY §2 P5) — no global index bookkeeping needed.
    """
    d = pos_j[None, :, :] - pos_i[:, None, :]  # d[i, j] = pos_j - pos_i
    dist2 = jnp.sum(d * d, axis=-1)
    pair = alive_i[:, None] & alive_j[None, :] & (dist2 >= 0.01)

    dist = jnp.sqrt(jnp.maximum(dist2, 1e-12))
    ip_i = type_i == PROTON
    ip_j = type_j == PROTON
    is_pp = ip_i[:, None] & ip_j[None, :]
    is_same = type_i[:, None] == type_j[None, :]

    net = pair_net_force(dist, dist2, is_pp, is_same, cfg)
    g = jnp.where(pair, net / dist, 0.0)  # force magnitude / dist
    return jnp.sum(g[:, :, None] * d, axis=1)


def compute_forces(pos, ptype, alive, cfg: SimConfig):
    """Total per-particle force (P, 2) from all pair terms + CoM spring."""
    m = alive
    count = jnp.sum(m.astype(jnp.float32))
    safe_count = jnp.maximum(count, 1.0)
    center = jnp.sum(pos * m[:, None], axis=0) / safe_count

    force = pair_forces_block(pos, ptype, m, pos, ptype, m, cfg)
    force = force + com_force(pos, center, safe_count, cfg) * m[:, None]
    return force


def chunk_plan(b: int, max_chunk: int):
    """Minimal-waste batch chunking: ``(n_chunks, chunk, pad)``.

    Pick the fewest chunks that respect ``max_chunk``, then size them
    evenly so the all-dead pad is at most ``chunk - 1`` rows. A prime
    batch (e.g. B=8209) still runs as 2 chunks (not B sequential
    dispatches), while a 10240 batch runs as 2x5120 with zero pad rather
    than 2x8192 (60% wasted rows). Shared by :func:`force_step` and
    ``core.step._batched_overlap``.
    """
    n_chunks = -(-b // max_chunk)
    chunk = -(-b // n_chunks)
    return n_chunks, chunk, n_chunks * chunk - b


def force_step(pos, vel, ptype, alive, dt, cfg: SimConfig, *, max_chunk=8192):
    """One fused force + integrate substep (nuclear_forces.py:156-171).

    Semi-implicit Euler: v += F*dt; v *= damping; x += v*dt.
    Dead slots pass through unchanged. Accepts (P, 2) or batched (B, P, 2)
    state (same contract as the Pallas backend).
    """
    if pos.ndim == 3:
        f = jax.vmap(lambda p, v, t, a: force_step(p, v, t, a, dt, cfg))
        b = pos.shape[0]
        # Chunk very large batches with lax.map: the vmapped pairwise chain
        # may materialize (B, P, P) intermediates in device memory (the
        # kernel backend keeps its pair tiles in registers).
        if b <= max_chunk:
            return f(pos, vel, ptype, alive)
        n_chunks, chunk, pad = chunk_plan(b, max_chunk)
        if pad:
            zpad = lambda x: jnp.concatenate(  # noqa: E731
                [x, jnp.zeros((pad, *x.shape[1:]), x.dtype)]
            )
            pos, vel, ptype, alive = map(zpad, (pos, vel, ptype, alive))
        n = n_chunks
        rs = lambda x: x.reshape(n, chunk, *x.shape[1:])  # noqa: E731
        out_p, out_v = jax.lax.map(
            lambda args: f(*args), (rs(pos), rs(vel), rs(ptype), rs(alive))
        )
        return (
            out_p.reshape(-1, *pos.shape[1:])[:b],
            out_v.reshape(-1, *vel.shape[1:])[:b],
        )
    if cfg.integrator == "leapfrog":
        return _leapfrog_step(pos, vel, ptype, alive, dt, cfg)
    if cfg.integrator != "euler":
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    force = compute_forces(pos, ptype, alive, cfg)
    new_vel = (vel + force * dt) * cfg.damping
    new_pos = pos + new_vel * dt
    m = alive[:, None]
    return jnp.where(m, new_pos, pos), jnp.where(m, new_vel, vel)


def _leapfrog_step(pos, vel, ptype, alive, dt, cfg: SimConfig):
    """Velocity-Verlet (kick-drift-kick): the flagged second-order upgrade
    over the reference's first-order scheme. Two force evaluations per
    step; damping applied once at the end to keep the reference's
    dissipative character."""
    f1 = compute_forces(pos, ptype, alive, cfg)
    v_half = vel + f1 * (0.5 * dt)
    new_pos = pos + v_half * dt
    f2 = compute_forces(new_pos, ptype, alive, cfg)
    new_vel = (v_half + f2 * (0.5 * dt)) * cfg.damping
    m = alive[:, None]
    return jnp.where(m, new_pos, pos), jnp.where(m, new_vel, vel)


# ---------------------------------------------------------------------------
# Pure-Python scalar oracle. Used by the unit tests as the closed-form
# ground truth, and by bench.py as the measured "reference CPU fallback"
# datum (same O(N^2) double loop shape as nuclear_forces.py:236-323).
# ---------------------------------------------------------------------------

def force_step_scalar(pos, vel, ptype, alive, dt, cfg: SimConfig):
    """Scalar twin of :func:`force_step` in plain Python floats."""
    p = len(pos)
    idx = [i for i in range(p) if alive[i]]
    count = len(idx)
    if count == 0:
        return [list(q) for q in pos], [list(v) for v in vel]
    cx = sum(pos[i][0] for i in idx) / count
    cy = sum(pos[i][1] for i in idx) / count
    min_allowed = cfg.nucleon_radius * cfg.hard_core_scale
    forces = [[0.0, 0.0] for _ in range(p)]
    for i in idx:
        fx = fy = 0.0
        for j in idx:
            if i == j:
                continue
            dx = pos[j][0] - pos[i][0]
            dy = pos[j][1] - pos[i][1]
            dist2 = dx * dx + dy * dy
            if dist2 < 0.01:
                continue
            dist = math.sqrt(dist2)
            f = 0.0
            if dist < min_allowed:
                f -= cfg.hard_core_strength * ((min_allowed - dist) / min_allowed) ** 1.5
            r_ratio = dist / cfg.strong_range
            if dist < cfg.strong_core_cut:
                f -= 0.7 * cfg.strong_strength / (dist2 + cfg.epsilon)
            elif dist < cfg.strong_attract_cut:
                f += 1.25 * cfg.strong_strength * math.exp(-r_ratio) / (dist + cfg.epsilon)
            else:
                f += 0.15 * cfg.strong_strength * math.exp(-r_ratio * 1.8) / (dist + cfg.epsilon)
            if ptype[i] == PROTON and ptype[j] == PROTON:
                f -= cfg.coulomb_strength / (dist2 + cfg.epsilon)
            if ptype[i] == ptype[j] and dist < cfg.pauli_range:
                f -= cfg.pauli_strength * math.exp(-dist / cfg.pauli_range * 2.0)
            f = max(-cfg.max_pair_force, min(cfg.max_pair_force, f))
            fx += dx * f / dist
            fy += dy * f / dist
        cdx = cx - pos[i][0]
        cdy = cy - pos[i][1]
        cdist = math.sqrt(cdx * cdx + cdy * cdy)
        nuclear_radius = 1.2 * count ** (1.0 / 3.0) * 2.0
        if cdist > nuclear_radius * 1.5 and cdist > 0.01:
            mag = cfg.com_spring * (cdist - nuclear_radius)
            fx += mag * cdx / cdist
            fy += mag * cdy / cdist
        forces[i] = [fx, fy]
    new_pos = [list(q) for q in pos]
    new_vel = [list(v) for v in vel]
    for i in idx:
        vx = (vel[i][0] + forces[i][0] * dt) * cfg.damping
        vy = (vel[i][1] + forces[i][1] * dt) * cfg.damping
        new_vel[i] = [vx, vy]
        new_pos[i] = [pos[i][0] + vx * dt, pos[i][1] + vy * dt]
    return new_pos, new_vel
