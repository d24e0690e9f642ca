"""Nucleon overlap resolution.

The reference separates overlapping pairs with an O(N^2) sequential
Gauss-Seidel sweep on the host every frame
(/root/reference/nuclear_sim.py:355-379): each pair closer than 5.0 is
pushed apart by half the overlap, degenerate pairs get a random direction.

Reformulated for an accelerator: a Jacobi projection — all pair pushes are computed
against the *same* snapshot and summed per particle, so the pass is one
masked (P, P) broadcast instead of a data-dependent sequential loop. One
Jacobi iteration resolves typical frame-to-frame overlap as effectively as
the reference's single sweep (both are approximate projections repeated
every frame); ``cfg.overlap_iterations`` allows more.

The pass runs once per frame, against up to 20 force sweeps, as plain
jnp that XLA fuses (batched and chunked in ``core.step._batched_overlap``).

Randomness: degenerate (coincident) pairs separate along the angle
``u_i + u_j`` from a (P,)-sized uniform draw (+pi on the j<i side so the
two sides push oppositely). A sum of uniforms mod 2pi is uniform, and the
pair direction is computed from per-particle cos/sin via the angle-sum
identity — no (P, P) randomness and no per-pair transcendentals.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pyqmd_tpu.config import SimConfig


def _rand_u(key, p: int):
    """Per-particle degenerate-separation angles for one Jacobi pass."""
    return jax.random.uniform(key, (p,), maxval=2.0 * jnp.pi)


def _resolve_once(pos, alive, u, cfg: SimConfig):
    p = pos.shape[0]
    md = cfg.overlap_min_dist
    d = pos[None, :, :] - pos[:, None, :]  # d[i, j] = pos_j - pos_i
    dist2 = jnp.sum(d * d, axis=-1)
    eye = jnp.eye(p, dtype=bool)
    pair = alive[:, None] & alive[None, :] & ~eye & (dist2 < md * md)

    dist = jnp.sqrt(jnp.maximum(dist2, 1e-12))
    # Degenerate-pair directions: cos/sin(u_i + u_j) by the angle-sum
    # identity from per-particle cos/sin, sign-flipped on the lower
    # triangle (cos(s + pi) = -cos(s)) so the two sides of each unordered
    # pair push in opposite directions (nuclear_sim.py:367-369).
    row = jax.lax.broadcasted_iota(jnp.int32, (p, p), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (p, p), 1)
    cu, su = jnp.cos(u), jnp.sin(u)
    cs = cu[:, None] * cu[None, :] - su[:, None] * su[None, :]
    ss = su[:, None] * cu[None, :] + cu[:, None] * su[None, :]
    sign = jnp.where(row < col, 1.0, -1.0)
    rand_dir = jnp.stack([sign * cs, sign * ss], axis=-1)
    degen = dist < 0.001
    direction = jnp.where(degen[..., None], rand_dir, d / dist[..., None])

    push = jnp.where(pair, (md - jnp.where(degen, 0.001, dist)) * 0.5, 0.0)
    # Sum the pair corrections per particle, but cap the displacement at
    # half the separation distance: a freshly placed nucleus has every
    # nucleon overlapping dozens of others, and an uncapped Jacobi sum
    # overshoots by the neighbor count and explodes the cluster in one
    # frame. The cap makes dense clusters peel outward a bounded amount per
    # frame — the gradual diffusive expansion of the reference's sequential
    # Gauss-Seidel sweep repeated every frame.
    delta = -jnp.sum(direction * push[..., None], axis=1)
    mag = jnp.linalg.norm(delta, axis=-1, keepdims=True)
    max_step = md * 0.5
    delta = delta * jnp.minimum(1.0, max_step / jnp.maximum(mag, 1e-9))
    return pos + jnp.where(alive[:, None], delta, 0.0)


def resolve_overlaps(pos, alive, key, cfg: SimConfig):
    """Run ``cfg.overlap_iterations`` Jacobi projection passes on one
    nucleus (``pos`` (P, 2))."""
    p = pos.shape[-2]
    for i in range(cfg.overlap_iterations):
        u = _rand_u(jax.random.fold_in(key, i), p)
        pos = _resolve_once(pos, alive, u, cfg)
    return pos
