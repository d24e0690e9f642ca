"""In-step radioactive-decay engine.

Everything the reference does across ``Nucleus.should_decay``
(/root/reference/particles.py:126-147), ``get_decay_product``
(/root/reference/decay_chains.py:203-245), ``Nucleus.adjust_particles``
(/root/reference/particles.py:149-203) and ``handle_decay``
(/root/reference/nuclear_sim.py:212-353) — reformulated as masked,
static-shape state transitions inside the jit-compiled step:

  * the Bernoulli decay draw uses counter-based ``jax.random`` instead of
    ``random.random()`` (reproducible across an ensemble),
  * branch selection is a table gather (:mod:`pyqmd_tpu.data.tables`),
  * alpha / nucleon-emission remove the lowest-indexed alive nucleons via
    rank masks instead of list surgery; beta flips mutate one type in place,
  * ejecta are written into a fixed ring buffer with per-type speeds and the
    reference's time-scale-compensated lifetimes,
  * decay counters are *actually incremented* (fixing the reference bug
    where ``decay_counts`` is displayed but never written, SURVEY §2 C15),
  * each event appends to a chain-log ring with the measured-or-synthetic
    duration record of nuclear_sim.py:239-255.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.dynamics import FrameDynamics
from pyqmd_tpu.data import tables
from pyqmd_tpu.state import (
    ALPHA,
    BASE_LIFETIMES,
    DECAY_BETA_MINUS,
    DECAY_BETA_PLUS,
    DECAY_NONE,
    DECAY_SPONTANEOUS_FISSION,
    EJECTA_SPEEDS,
    ELECTRON,
    GAMMA,
    NEUTRON,
    POSITRON,
    PROTON,
    NucleusState,
)

LN2_REF = 0.693  # the reference's truncated ln(2) (particles.py:140)

# Ejecta particle type emitted per decay mode (decay_chains.py:235-243 and
# the create_* factories at :331-371). Fission is handled separately.
_DECAY_EJECTA_TYPE = np.array(
    [0, ALPHA, ELECTRON, POSITRON, GAMMA, NEUTRON, PROTON, ALPHA], np.int32
)

# Nucleons removed per decay mode: (protons, neutrons) (particles.py:155-177).
_REMOVE_P = np.array([0, 2, 0, 0, 0, 0, 1, 0], np.int32)
_REMOVE_N = np.array([0, 2, 0, 0, 0, 1, 0, 0], np.int32)

# Modes whose adjust_particles path applies the 0.8 velocity damping
# (particles.py:200-203; the beta branches return before it, :158-171).
_APPLIES_DAMPING = np.array([0, 1, 0, 0, 0, 1, 1, 0], bool)


def decay_probability(half_life, dt):
    """Dual-regime decay probability (particles.py:126-147).

    Exact ``1 - 0.5**(dt/T)`` when dt is large relative to the half-life,
    linearized ``0.693/T * dt`` otherwise, clamped to [0, 1]; stable nuclei
    (T = inf) never decay.
    """
    hl = jnp.maximum(half_life, 1e-30)
    big = 1.0 - jnp.exp2(-dt / hl)
    small = LN2_REF / hl * dt
    p = jnp.where(dt > hl * 0.01, big, small)
    p = jnp.clip(p, 0.0, 1.0)
    return jnp.where(jnp.isinf(half_life), 0.0, p)


def ejecta_lifetime(frag_type, dyn: FrameDynamics, cfg: SimConfig):
    """Ejecta lifetime with the reference's time-scale/substep/dt
    compensation (nuclear_sim.py:315-342)."""
    base = cfg.base_ejecta_lifetime
    ts, ss = dyn.time_scale, dyn.substeps
    # The dt factor reads the RAW physics dt (nuclear_sim.py:327 uses
    # self.physics_dt before the accuracy scaling).
    pdt = dyn.raw_physics_dt if dyn.raw_physics_dt is not None else dyn.physics_dt
    # Fast-time branch (ts > 1).
    tf = jnp.maximum(1.0, ts / 100.0)
    sf = jnp.maximum(1.0, jnp.sqrt(ss))
    df = jnp.maximum(1.0, 0.016 / pdt)
    fast = jnp.maximum(base * sf, base * tf * sf * df)
    fast = jnp.where(ss > 15.0, fast * (ss / 15.0), fast)
    # Slow/real-time branch: at least the per-type base lifetime.
    type_base = jnp.asarray(BASE_LIFETIMES)[frag_type]
    slow = jnp.maximum(type_base, base * jnp.maximum(1.0, ss / 5.0))
    return jnp.where(ts > 1.0, fast, slow)


def _first_rank_masks(state: NucleusState):
    """Per-slot rank among alive protons / neutrons (lowest index = rank 0),
    the masked equivalent of the reference's first-in-list scans
    (particles.py:158-189)."""
    alive_p = state.alive & (state.ptype == PROTON)
    alive_n = state.alive & (state.ptype == NEUTRON)
    prank = jnp.cumsum(alive_p.astype(jnp.int32)) - 1
    nrank = jnp.cumsum(alive_n.astype(jnp.int32)) - 1
    return alive_p, alive_n, prank, nrank


# --- packed nucleon bitfields (decay-only statistics path) -----------------
#
# The rank-mask adjustment above runs ~P lanes of (B, P) work per substep,
# most of them on padding at small P. The stats frame instead carries
# (alive, is-proton) as ceil(P/32) uint32 words per nucleus — slot j lives in word j//32 bit j%32, so "the first
# rm alive protons" is a lowest-set-bits extraction: dense (B, W) ops on
# the batch axis. Removal counts are at most 2 (_REMOVE_P/_REMOVE_N), so
# two x & (-x) rounds per word suffice. Pack/unpack happens once per
# FRAME, outside the substep scan; the resulting alive/ptype are bitwise
# identical to the rank-mask path (pinned by tests/test_batch_native.py).


def pack_nucleon_bits(alive, ptype):
    """(..., P) alive/ptype -> two (..., W) uint32 bitfields
    (alive bits, is-proton bits). Proton bits cover ALL slots — dead and
    padding slots keep their ptype through pack/unpack, matching the
    rank-mask path which never touches them (nucleus-slot ptypes are
    always PROTON=0 or NEUTRON=1)."""
    p = alive.shape[-1]
    w = -(-p // 32)
    pad = w * 32 - p

    def pk(v):
        vv = v.astype(jnp.uint32)
        if pad:
            vv = jnp.concatenate(
                [vv, jnp.zeros(vv.shape[:-1] + (pad,), jnp.uint32)], -1
            )
        vv = vv.reshape(vv.shape[:-1] + (w, 32))
        return jnp.sum(
            vv << jnp.arange(32, dtype=jnp.uint32), axis=-1, dtype=jnp.uint32
        )

    return pk(alive), pk(ptype == PROTON)


def unpack_alive_ptype(alive_bits, proton_bits, p):
    """Inverse of :func:`pack_nucleon_bits`: (..., W) uint32 pairs back to
    (..., P) bool alive and int32 ptype."""
    bits = jnp.arange(p, dtype=jnp.uint32)
    w_idx = (bits // 32).astype(jnp.int32)
    b_idx = bits % 32

    def up(x):
        return ((x[..., w_idx] >> b_idx) & 1).astype(bool)

    alive = up(alive_bits)
    ptype = jnp.where(up(proton_bits), PROTON, NEUTRON).astype(jnp.int32)
    return alive, ptype


def _lowest_set_bits(x, r):
    """Mask of the lowest min(r, popcount) set bits of the (W,) uint32
    bitfield ``x`` (r a traced scalar <= 2), scanning words low to high."""
    one = jnp.uint32(1)
    zero = jnp.uint32(0)
    out = []
    for wd in range(x.shape[0]):
        xw = x[wd]
        b1 = xw & (~xw + one)
        x2 = xw ^ b1
        b2 = x2 & (~x2 + one)
        k1 = jnp.where(r >= 1, b1, zero)
        r = r - (k1 != 0).astype(r.dtype)
        k2 = jnp.where(r >= 1, b2, zero)
        r = r - (k2 != 0).astype(r.dtype)
        out.append(k1 | k2)
    return jnp.stack(out)


def _first_set_bit(x):
    """Mask of the single lowest set bit across the (W,) uint32 bitfield
    ``x`` (all-zero when x is empty)."""
    one = jnp.uint32(1)
    out = []
    found = None
    for wd in range(x.shape[0]):
        b = x[wd] & (~x[wd] + one)
        if found is None:
            out.append(b)
            found = b != 0
        else:
            out.append(jnp.where(found, jnp.uint32(0), b))
            found = found | (b != 0)
    return jnp.stack(out)


def _decay_draw_count(cfg: SimConfig) -> int:
    """Uniform draws consumed by :func:`_apply_decay_from_draws`:
    branch, duration, half-life estimate, fragment count, then per-slot
    fragment types and angles."""
    return 4 + 2 * cfg.max_ejecta_per_event


def apply_decay(
    state: NucleusState,
    cfg: SimConfig,
    key: jax.Array,
    did: jax.Array,
    dyn: FrameDynamics,
) -> tuple[NucleusState, jax.Array]:
    """Apply one (possibly suppressed) decay event; returns (state, dtype).

    ``did`` is a traced bool — the whole transition is computed and masked,
    the idiomatic replacement for the reference's host-side ``if`` at
    nuclear_sim.py:166-167. The returned ``dtype`` is DECAY_NONE when no
    event fired.
    """
    return _apply_decay_from_draws(
        state, cfg, jax.random.uniform(key, (_decay_draw_count(cfg),)), did, dyn
    )


def _apply_decay_from_draws(
    state: NucleusState,
    cfg: SimConfig,
    u: jax.Array,
    did: jax.Array,
    dyn: FrameDynamics,
    row_tables: bool = False,
    stats_only: bool = False,
    packed_nucleons=None,
):
    """:func:`apply_decay` body over pre-drawn uniforms.

    All of a substep's randomness comes in as ONE ``(4 + 2·k_e,)`` uniform
    vector — a single threefry block — instead of the 2 key splits + 7
    separate draws of the original formulation, since at batch=1 the decay
    path is bound by the latency of its random draws.

    ``stats_only`` (the decay-only statistics frame) skips the ejecta-ring
    writes and the decay velocity damping — 2·k_e·6 masked whole-(E,)
    selects per substep that only matter for rendering. Positions,
    velocities and ejecta are documented-stale in that frame; the uniform
    vector is still drawn and consumed identically, so the isotope
    trajectories (z, n, half_life, decay_counts, chain log, RNG stream)
    stay bitwise identical to the full-physics frame.
    """
    k_e = cfg.max_ejecta_per_event
    u_branch, u_dur, u_hl, u_nfrag = u[0], u[1], u[2], u[3]
    u_ftype = u[4 : 4 + k_e]
    u_ang = u[4 + k_e : 4 + 2 * k_e]

    # Table access form (bitwise-identical results, different lowering):
    # batched frames use ONE packed-row gather per cell, the single-nucleus
    # path flat scalar takes. Which form is faster on the GPU is a
    # hypothesis, not measured here (ROADMAP D8).
    if row_tables:
        new_z, new_n, dtype = tables.sample_branch_from_row(
            tables.lookup_row(state.z, state.n), u_branch
        )
    else:
        new_z, new_n, dtype = tables.sample_branch(state.z, state.n, u_branch)
    eff = did & (dtype != DECAY_NONE)
    effi = eff.astype(jnp.int32)
    efff = eff.astype(jnp.float32)

    # --- chain-record duration: measured sim time since the last decay, or
    # an Exp(T/ln2)-distributed synthetic draw when it rounds to zero
    # (nuclear_sim.py:239-255).
    measured = state.time_passed - state.last_decay_time
    hl = state.half_life
    hl_safe = jnp.where(jnp.isinf(hl), 1.0, hl)
    rand_factor = -jnp.log(jnp.maximum(u_dur, 1e-20))
    alt = jnp.where(measured > 0.0, measured, hl_safe)
    synth = jnp.minimum(hl_safe * rand_factor / LN2_REF, alt)
    synth = jnp.where(jnp.isinf(hl), 0.0, synth)
    duration = jnp.where((measured < 0.001) | (hl < 0.001), synth, measured)

    # Chain-ring write as an elementwise masked update instead of a scatter:
    # dynamic-index scatters break XLA fusion.
    slot = state.chain_cursor % cfg.max_chain_log
    slot_mask = (jnp.arange(cfg.max_chain_log) == slot) & eff

    def masked_set(arr, value):
        return jnp.where(slot_mask, value, arr)

    # --- nucleon adjustment (particles.py:149-203).
    rm_p = jnp.asarray(_REMOVE_P)[dtype]
    rm_n = jnp.asarray(_REMOVE_N)[dtype]
    if packed_nucleons is not None:
        # Bitfield form (stats frame): same first-rank semantics on dense
        # (W,) uint32 words — see pack_nucleon_bits above.
        assert stats_only, "packed nucleon bitfields are stats-only"
        ab, pb = packed_nucleons
        apb = ab & pb
        anb = ab & ~pb
        full = jnp.uint32(0xFFFFFFFF)
        effm = jnp.where(eff, full, jnp.uint32(0))
        kill_bits = _lowest_set_bits(apb, rm_p) | _lowest_set_bits(anb, rm_n)
        new_ab = ab & ~(kill_bits & effm)
        bminus = jnp.where(
            eff & (dtype == DECAY_BETA_MINUS), full, jnp.uint32(0)
        )
        bplus = jnp.where(
            eff & (dtype == DECAY_BETA_PLUS), full, jnp.uint32(0)
        )
        new_pb = (pb | (_first_set_bit(anb) & bminus)) & ~(
            _first_set_bit(apb) & bplus
        )
        new_packed = (new_ab, new_pb)
        new_alive, new_ptype = state.alive, state.ptype  # excluded leaves
    else:
        alive_p, alive_n, prank, nrank = _first_rank_masks(state)
        kill = (alive_p & (prank < rm_p)) | (alive_n & (nrank < rm_n))
        new_alive = state.alive & ~(kill & eff)

        flip_to_p = eff & (dtype == DECAY_BETA_MINUS) & alive_n & (nrank == 0)
        flip_to_n = eff & (dtype == DECAY_BETA_PLUS) & alive_p & (prank == 0)
        new_ptype = jnp.where(flip_to_p, PROTON, state.ptype)
        new_ptype = jnp.where(flip_to_n, NEUTRON, new_ptype)

    if stats_only:
        new_vel = state.vel
    else:
        damp = eff & jnp.asarray(_APPLIES_DAMPING)[dtype]
        new_vel = jnp.where(damp, state.vel * cfg.decay_damping, state.vel)

        # --- ejecta spawn at the post-adjustment center of mass
        # (nuclear_sim.py:290-294 updates CoM before creating products).
        w = new_alive.astype(jnp.float32)
        cnt = jnp.maximum(jnp.sum(w), 1.0)
        com = jnp.sum(state.pos * w[:, None], axis=0) / cnt

        is_fission = dtype == DECAY_SPONTANEOUS_FISSION
        # randint(2, 3) inclusive (decay_chains.py:377).
        nfrag_fission = 2 + (u_nfrag < 0.5).astype(jnp.int32)
        nfrag = jnp.where(is_fission, nfrag_fission, 1)
        frag_idx = jnp.arange(k_e)
        frag_active = eff & (frag_idx < nfrag)

        # Fragment types: fixed per decay mode; fission fragments are alpha
        # with p=0.7 else neutron (decay_chains.py:383-388).
        fission_type = jnp.where(u_ftype < 0.7, ALPHA, NEUTRON)
        frag_type = jnp.where(
            is_fission, fission_type, jnp.asarray(_DECAY_EJECTA_TYPE)[dtype]
        )

        # Velocity: random angle, renormalized to the per-type base speed —
        # the reference normalizes each creator velocity to a fixed base
        # speed (nuclear_sim.py:296-313), so only the random direction
        # survives.
        angles = u_ang * (2.0 * jnp.pi)
        speed = jnp.asarray(EJECTA_SPEEDS)[frag_type]
        frag_vel = speed[:, None] * jnp.stack(
            [jnp.cos(angles), jnp.sin(angles)], -1
        )
        frag_life = ejecta_lifetime(frag_type, dyn, cfg)

        # Ejecta-ring write, also scatter-free: ring slot s receives
        # fragment k iff (s - cursor) mod E == k. k_e is a small static
        # constant, so the update unrolls to k_e whole-(E,) masked selects
        # — no gather, no scatter, pure elementwise work.
        e_cap = cfg.max_ejecta
        rel = (jnp.arange(e_cap) - state.ej_cursor) % e_cap

        def ej_set(arr, value):
            shaped = jnp.broadcast_to(value, (k_e,) + arr.shape[1:])
            out = arr
            for k in range(k_e):
                mask = (rel == k) & frag_active[k]
                if arr.ndim > 1:
                    mask = mask[:, None]
                out = jnp.where(mask, shaped[k], out)
            return out

    # --- daughter identity + half-life + metrics.
    z2 = jnp.where(eff, new_z, state.z).astype(jnp.int32)
    n2 = jnp.where(eff, new_n, state.n).astype(jnp.int32)
    hl2 = jnp.where(
        eff,
        tables.half_life_from_row(tables.lookup_row(new_z, new_n), u_hl)
        if row_tables
        else tables.half_life(new_z, new_n, u_hl),
        hl
    )

    if stats_only:
        ej_updates = {}
    else:
        ej_updates = dict(
            ej_pos=ej_set(state.ej_pos, com[None, :]),
            ej_vel=ej_set(state.ej_vel, frag_vel),
            ej_type=ej_set(state.ej_type, frag_type),
            ej_age=ej_set(state.ej_age, jnp.zeros((k_e,), jnp.float32)),
            ej_life=ej_set(state.ej_life, frag_life),
            ej_alive=ej_set(state.ej_alive, jnp.ones((k_e,), bool)),
            ej_cursor=state.ej_cursor + jnp.sum(frag_active.astype(jnp.int32)),
        )
    new_state = state.replace(
        vel=new_vel,
        ptype=new_ptype,
        alive=new_alive,
        z=z2,
        n=n2,
        half_life=hl2,
        **ej_updates,
        decay_counts=jnp.where(
            jnp.arange(state.decay_counts.shape[0]) == dtype,
            state.decay_counts + effi,
            state.decay_counts,
        ),
        last_decay_time=jnp.where(eff, state.time_passed, state.last_decay_time),
        chain_z0=masked_set(state.chain_z0, state.z),
        chain_n0=masked_set(state.chain_n0, state.n),
        chain_dtype=masked_set(state.chain_dtype, dtype),
        chain_z1=masked_set(state.chain_z1, new_z),
        chain_n1=masked_set(state.chain_n1, new_n),
        chain_time=masked_set(state.chain_time, duration * efff),
        chain_cursor=state.chain_cursor + effi,
    )
    dtype_out = jnp.where(eff, dtype, DECAY_NONE)
    if packed_nucleons is not None:
        return new_state, dtype_out, new_packed
    return new_state, dtype_out


def maybe_decay(
    state: NucleusState,
    cfg: SimConfig,
    key: jax.Array,
    dyn: FrameDynamics,
    row_tables: bool = False,
    stats_only: bool = False,
    packed_nucleons=None,
):
    """Bernoulli decay check for one substep (nuclear_sim.py:164-167).

    The whole substep draws ONE uniform vector (Bernoulli draw + every
    event draw) from the substep key — a single threefry block.
    ``row_tables`` selects the batched-frame table-gather form and
    ``stats_only`` the ejecta-free statistics form (see
    :func:`_apply_decay_from_draws`); isotope trajectories are bitwise
    identical either way. With ``packed_nucleons`` (stats frame) a third
    return element carries the updated bitfields."""
    u = jax.random.uniform(key, (1 + _decay_draw_count(cfg),))
    return maybe_decay_from_u(
        state, cfg, u, dyn, row_tables, stats_only, packed_nucleons
    )


def maybe_decay_from_u(
    state: NucleusState,
    cfg: SimConfig,
    u: jax.Array,
    dyn: FrameDynamics,
    row_tables: bool = False,
    stats_only: bool = False,
    packed_nucleons=None,
):
    """:func:`maybe_decay` over a pre-drawn ``(1 + draw_count,)`` uniform
    vector — the seam for callers that source the substep's threefry block
    elsewhere. The batched frames draw inside the substep scan instead.)"""
    p = decay_probability(state.half_life, dyn.step_time)
    did = u[0] < p
    return _apply_decay_from_draws(
        state, cfg, u[1:], did, dyn, row_tables, stats_only, packed_nucleons
    )


def force_decay(
    state: NucleusState, cfg: SimConfig, key: jax.Array, dyn: FrameDynamics
) -> tuple[NucleusState, jax.Array]:
    """Unconditional decay — the SPACE-key fault-injection hook
    (nuclear_sim.py:433-434)."""
    return apply_decay(state, cfg, key, jnp.asarray(True), dyn)
