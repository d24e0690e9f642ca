"""The simulation step: substeps under ``lax.scan`` inside one jit.

This is the accelerator-resident equivalent of the reference's frame update
(/root/reference/nuclear_sim.py:118-176), which per substep (up to 20 per
frame) runs a host loop over ejecta, a host-side decay Bernoulli, and a
full host<->device round trip for the force kernel
(nuclear_forces.py:190-234). Here one compiled XLA program advances ejecta,
samples decays, and integrates forces for *all* substeps, then resolves
overlaps — no host transfer anywhere. The ensemble version is the same
function under ``vmap``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core import forces as _forces
from pyqmd_tpu.core.decay import maybe_decay
from pyqmd_tpu.core.dynamics import FrameDynamics
from pyqmd_tpu.core.overlap import resolve_overlaps
from pyqmd_tpu.state import ALPHA, NucleusState


def select_force_step(cfg: SimConfig):
    """Pick the force backend (reference GPU-or-CPU dispatch analog,
    nuclear_sim.py:169-173)."""
    if cfg.force_backend == "pallas":
        if cfg.integrator not in ("euler", "leapfrog"):
            raise ValueError(f"unknown integrator {cfg.integrator!r}")
        from pyqmd_tpu.kernels.forces_pallas import force_step_pallas

        return force_step_pallas
    if cfg.force_backend == "jnp":
        return _forces.force_step
    raise ValueError(f"unknown force backend {cfg.force_backend!r}")


def advance_ejecta(state: NucleusState, cfg: SimConfig, dyn: FrameDynamics) -> NucleusState:
    """Ejecta advection + aging + expiry (nuclear_sim.py:178-210).

    Animated decay products (alpha/e-/gamma/e+) move at a fixed animation
    timestep with substep-compensated speed and age with the reference's
    time-scale-damped rate; emitted nucleons advect with
    ``dt * sqrt(time_scale)`` and never expire.
    """
    is_anim = state.ej_type >= ALPHA  # alpha/electron/gamma/positron
    substep_factor = 10.0 / jnp.maximum(1.0, dyn.substeps)
    anim_step = cfg.animation_dt * cfg.ejecta_speed_scale * substep_factor
    nucleon_step = dyn.physics_dt * jnp.sqrt(dyn.time_scale)
    step = jnp.where(is_anim, anim_step, nucleon_step)

    live = state.ej_alive
    new_pos = state.ej_pos + state.ej_vel * jnp.where(live, step, 0.0)[:, None]

    aging_scale = jnp.minimum(
        1.0,
        1.0
        / (
            jnp.sqrt(jnp.maximum(1.0, dyn.time_scale / 100.0))
            * jnp.sqrt(jnp.maximum(1.0, dyn.substeps / 10.0))
        ),
    )
    age_inc = jnp.where(is_anim, dyn.step_time * aging_scale, dyn.step_time)
    new_age = state.ej_age + jnp.where(live, age_inc, 0.0)
    expired = is_anim & (new_age >= state.ej_life)
    return state.replace(
        ej_pos=new_pos, ej_age=new_age, ej_alive=live & ~expired
    )


def substep(
    state: NucleusState,
    cfg: SimConfig,
    dyn: FrameDynamics,
    key: jax.Array,
    force_step_fn=None,
) -> NucleusState:
    """One physics substep: ejecta, decay check, force+integrate
    (nuclear_sim.py:161-173).

    ``force_step_fn`` overrides the backend dispatch — used by the
    particle-axis ppermute ring (SURVEY §2 P5) to run the force step
    sharded while the rest of the frame stays replicated.
    """
    state = advance_ejecta(state, cfg, dyn)
    state, _ = maybe_decay(state, cfg, key, dyn)
    fstep = force_step_fn or select_force_step(cfg)
    pos, vel = fstep(
        state.pos, state.vel, state.ptype, state.alive, dyn.physics_dt, cfg
    )
    return state.replace(pos=pos, vel=vel)


def simulate_frame(
    state: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
    force_step_fn=None,
) -> tuple[NucleusState, dict]:
    """Advance one frame: ``num_steps`` substeps under ``lax.scan`` then
    overlap resolution (nuclear_sim.py:118-176).

    ``num_steps`` is static (the scan length); ``time_scale``, ``frame_dt``
    and ``physics_dt`` are traced, so interactive time-scale changes and the
    auto-substep adjustment (nuclear_sim.py:131-142) never recompile.
    Returns (new_state, metrics).
    """
    time_scale = jnp.asarray(time_scale, jnp.float32)
    frame_dt = jnp.asarray(frame_dt, jnp.float32)
    if physics_dt is None:
        physics_dt = cfg.effective_dt()
    desired_dt = frame_dt * time_scale
    # time_passed advances at frame start (nuclear_sim.py:124), so every
    # substep's decay record sees the same frame clock.
    state = state.replace(time_passed=state.time_passed + desired_dt)

    dyn = FrameDynamics(
        time_scale=time_scale,
        substeps=jnp.asarray(float(num_steps), jnp.float32),
        physics_dt=jnp.asarray(physics_dt, jnp.float32),
        step_time=desired_dt / num_steps,
        raw_physics_dt=(
            None if raw_physics_dt is None
            else jnp.asarray(raw_physics_dt, jnp.float32)
        ),
    )

    base = jax.random.wrap_key_data(state.rng)
    key_steps, key_overlap, key_next = jax.random.split(base, 3)

    def body(st, k):
        return substep(st, cfg, dyn, k, force_step_fn), None

    state, _ = jax.lax.scan(body, state, jax.random.split(key_steps, num_steps))

    pos = resolve_overlaps(state.pos, state.alive, key_overlap, cfg)
    state = state.replace(
        pos=pos, rng=jax.random.key_data(key_next).astype(jnp.uint32)
    )
    return state, state_metrics(state)


# Per-nucleus metric keys produced by state_metrics — the single source of
# truth the sharded frame builders derive their shard_map out_specs from
# (a hand-copied key set there would break opaquely when a metric is added).
METRIC_KEYS = (
    "nan", "alive", "kinetic", "z", "n", "half_life", "decay_counts",
    "time_passed", "com", "chain_cursor", "rms_radius",
)

# Ensemble aggregates added by ensemble_step / the sharded frame builders
# (replicated across shards, psum'd over the data axis).
AGGREGATE_METRIC_KEYS = ("total_decay_counts", "total_alive", "survivors")


def state_metrics(state: NucleusState) -> dict:
    """Observable metrics of a state; works unbatched or batched.

    Includes the step-level NaN guard (SURVEY §5 failure detection): the
    reference silently skips a failed kernel launch
    (nuclear_forces.py:222-224); here numerical blowup is surfaced as a
    metric the driver checks.

    Keys must stay in sync with METRIC_KEYS above.
    """
    return {
        "nan": ~jnp.all(
            jnp.isfinite(state.pos) & jnp.isfinite(state.vel), axis=(-1, -2)
        ),
        "alive": state.alive_count(),
        "kinetic": state.kinetic_energy(),
        "z": state.z,
        "n": state.n,
        "half_life": state.half_life,
        "decay_counts": state.decay_counts,
        "time_passed": state.time_passed,
        "com": state.center_of_mass(),
        "chain_cursor": state.chain_cursor,
        "rms_radius": state.rms_radius(),
    }


def _batched_overlap(pos, alive, keys, cfg: SimConfig, max_chunk: int = 1024):
    """Overlap resolution over a batch.

    A plain vmap materializes ~10 (B, P, P) temporaries — 17 GB each at a
    64k ensemble — so batches beyond ``max_chunk`` are processed in
    sequential ``lax.map`` chunks (the pass is a small share of a frame's
    work; latency is immaterial). Per-member key folding and angle draws
    match the single-nucleus path exactly, keeping ``ensemble_step``
    bitwise-equal to ``vmap(simulate_frame)``.
    """
    f = jax.vmap(lambda p, a, k: resolve_overlaps(p, a, k, cfg))
    b = pos.shape[0]
    if b <= max_chunk:
        return f(pos, alive, keys)
    # Minimal-waste chunking (chunk_plan, core/forces.py): fewest chunks
    # respecting max_chunk, sized evenly, so pad ≤ chunk-1 — a prime batch
    # (e.g. B=8209) runs as a handful of chunks rather than B sequential
    # dispatches, and a 10240 batch wastes zero rows. Padded members are
    # all-dead: resolve_overlaps is a no-op on them.
    n_chunks, chunk, pad = _forces.chunk_plan(b, max_chunk)
    if pad:
        pos = jnp.concatenate([pos, jnp.zeros((pad, *pos.shape[1:]), pos.dtype)])
        alive = jnp.concatenate(
            [alive, jnp.zeros((pad, *alive.shape[1:]), alive.dtype)]
        )
        keys = jnp.concatenate([keys, keys[:pad]])
    n = (b + pad) // chunk
    out = jax.lax.map(
        lambda args: f(*args),
        (
            pos.reshape(n, chunk, *pos.shape[1:]),
            alive.reshape(n, chunk, *alive.shape[1:]),
            keys.reshape(n, chunk, *keys.shape[1:]),
        ),
    )
    return out.reshape(n * chunk, *pos.shape[1:])[:b]


def _batched_frame_preamble(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt,
    raw_physics_dt,
):
    """Shared batched-frame preamble: clock advance, ``FrameDynamics``
    and the per-nucleus PRNG split structure (base → 3-way split →
    per-substep keys).

    :func:`ensemble_step` and :func:`decay_ensemble_step` MUST both
    derive their randomness through this one helper — the stats frame's
    bitwise-identity guarantee (tests/test_batch_native.py) rests on the
    two paths splitting identical key trees, and a hand-copied preamble
    would silently desynchronize them on the next edit."""
    time_scale = jnp.asarray(time_scale, jnp.float32)
    frame_dt = jnp.asarray(frame_dt, jnp.float32)
    if physics_dt is None:
        physics_dt = cfg.effective_dt()
    desired_dt = frame_dt * time_scale
    states = states.replace(time_passed=states.time_passed + desired_dt)

    dyn = FrameDynamics(
        time_scale=time_scale,
        substeps=jnp.asarray(float(num_steps), jnp.float32),
        physics_dt=jnp.asarray(physics_dt, jnp.float32),
        step_time=desired_dt / num_steps,
        raw_physics_dt=(
            None if raw_physics_dt is None
            else jnp.asarray(raw_physics_dt, jnp.float32)
        ),
    )

    base = jax.vmap(jax.random.wrap_key_data)(states.rng)
    k3 = jax.vmap(lambda k: jax.random.split(k, 3))(base)  # (B, 3)
    step_keys = jax.vmap(lambda k: jax.random.split(k, num_steps))(k3[:, 0])
    step_keys = jnp.swapaxes(step_keys, 0, 1)  # (S, B) keys
    return states, dyn, k3, step_keys


def ensemble_step(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
    force_step_fn=None,
) -> tuple[NucleusState, dict]:
    """Batched frame over a leading ensemble axis (SURVEY §2 P1).

    Not simply ``vmap(simulate_frame)``: the per-nucleus parts (ejecta,
    decay, overlap) are vmapped, but the force step is called *batch-native*
    so the kernel sees the whole (B, P) ensemble and groups small nuclei
    into its programs — under vmap each nucleus would be a call of its
    own. Per-nucleus PRNG key derivation matches
    :func:`simulate_frame` exactly, so results are bitwise-identical to the
    vmapped form for a given force backend.

    Per-nucleus metrics keep their batch axis; aggregate decay statistics
    are summed on device so host readback is O(1) regardless of ensemble
    size.
    """
    states, dyn, k3, step_keys = _batched_frame_preamble(
        states, cfg, time_scale, frame_dt, num_steps, physics_dt,
        raw_physics_dt,
    )

    fstep = force_step_fn or select_force_step(cfg)

    def body(st, keys):
        st = jax.vmap(lambda s: advance_ejecta(s, cfg, dyn))(st)
        st = jax.vmap(
            lambda s, k: maybe_decay(s, cfg, k, dyn, row_tables=True)[0]
        )(st, keys)
        pos, vel = fstep(st.pos, st.vel, st.ptype, st.alive, dyn.physics_dt, cfg)
        return st.replace(pos=pos, vel=vel), None

    states, _ = jax.lax.scan(body, states, step_keys)

    pos = _batched_overlap(states.pos, states.alive, k3[:, 1], cfg)
    states = states.replace(
        pos=pos,
        rng=jax.vmap(lambda k: jax.random.key_data(k).astype(jnp.uint32))(k3[:, 2]),
    )

    metrics = state_metrics(states)
    metrics["total_decay_counts"] = jnp.sum(metrics["decay_counts"], axis=0)
    metrics["total_alive"] = jnp.sum(metrics["alive"])
    return states, metrics


def decay_ensemble_step(
    states: NucleusState,
    cfg: SimConfig,
    time_scale,
    frame_dt,
    num_steps: int,
    physics_dt=None,
    raw_physics_dt=None,
) -> tuple[NucleusState, dict]:
    """Decay-statistics-only batched frame: Bernoulli decay + branch
    sampling + masked particle adjustment, skipping ejecta advection, the
    force step and overlap resolution — none of which can change WHICH
    isotope a nucleus is.

    The PRNG split structure is identical to :func:`ensemble_step` (the
    force step consumes no randomness; the overlap key is split but
    unused), so the isotope trajectories — z, n, half_life, decay_counts
    and the chain log — are **bitwise identical** to the full-physics
    frame (pinned by tests/test_batch_native.py); only positions,
    velocities and ejecta go stale (the ejecta-ring writes and the decay
    velocity damping are skipped outright via ``stats_only`` — they were
    most of the decay pass's HBM traffic). O(B·P) per substep instead of
    O(B·P²): the statistics workflows (`analysis.survival_curve`,
    `analysis.chain_populations`) run orders of magnitude faster for
    heavy isotopes.
    """
    states, dyn, k3, step_keys = _batched_frame_preamble(
        states, cfg, time_scale, frame_dt, num_steps, physics_dt,
        raw_physics_dt,
    )

    # The stats-only decay path never reads or writes the ejecta ring, so
    # the (B, E) ejecta leaves ride OUTSIDE the scan carry entirely (None
    # is an empty pytree subtree): zero per-substep HBM traffic for them.
    # Positions, velocities and the (post-scan-replaced) rng
    # leaf ride outside too: with ``stats_only`` the decay transition
    # neither reads nor writes them (apply_decay computes no CoM and skips
    # the velocity damping), and at pad_to=8 the (B, P, 2) pos/vel pair
    # was the single widest carry component (128 of ~424 B/nucleus).
    ej_fields = (
        "ej_pos", "ej_vel", "ej_type", "ej_age", "ej_life", "ej_alive",
        "ej_cursor", "pos", "vel", "rng",
    )
    ej_saved = {f: getattr(states, f) for f in ej_fields}
    states = states.replace(**{f: None for f in ej_fields})

    # Narrow the integer carry leaves at the scan boundary: the scan's
    # HBM traffic is the carry width, and Z < 128, N < 192, particle
    # types < 6 and decay types < 8 all fit uint8. The casts happen
    # INSIDE the substep body, where XLA fuses them into the update —
    # the compute still runs in int32,
    # so trajectories stay bitwise identical; only the
    # between-substep representation narrows (~424 → ~138 B/nucleus
    # at pad_to=8 with the pos/vel/rng exclusion above).
    # decay_counts stays int32: per-nucleus counts are UNBOUNDED on
    # self-looping chains (Tc-99m's γ branch re-enters (43,56) per
    # the reference data, PARITY departure 8) and a uint16 carry
    # would silently wrap at 65535 events on long statistics runs.
    narrow_to = {
        "z": jnp.uint8, "n": jnp.uint8,
        "chain_z0": jnp.uint8, "chain_n0": jnp.uint8,
        "chain_dtype": jnp.uint8, "chain_z1": jnp.uint8,
        "chain_n1": jnp.uint8,
    }
    wide_dtypes = {f: getattr(states, f).dtype for f in narrow_to}

    def cast(st, dtypes):
        return st.replace(
            **{f: getattr(st, f).astype(d) for f, d in dtypes.items()}
        )

    # alive/ptype ride the scan as packed uint32 bitfields: the
    # (B, P) rank-mask adjustment is mostly padding at pad_to=8; the
    # bitfield form is a few dense (B, W) word ops with bitwise-identical results
    # (core/decay.py pack_nucleon_bits).
    from pyqmd_tpu.core.decay import pack_nucleon_bits, unpack_alive_ptype

    p_cap = states.alive.shape[-1]
    bits0 = pack_nucleon_bits(states.alive, states.ptype)
    states = states.replace(alive=None, ptype=None)

    def body(carry, keys):
        # st's ejecta/pos/vel/rng/alive/ptype leaves are None (empty
        # subtrees): the stats-only decay path reads none of them.
        st, bits = carry
        st = cast(st, wide_dtypes)
        st, bits = jax.vmap(
            lambda s, a, pb, k: (
                lambda r: (r[0], r[2])
            )(
                maybe_decay(
                    s, cfg, k, dyn, row_tables=True, stats_only=True,
                    packed_nucleons=(a, pb),
                )
            )
        )(st, bits[0], bits[1], keys)
        return (cast(st, narrow_to), bits), None

    (states, bits), _ = jax.lax.scan(
        body, (cast(states, narrow_to), bits0), step_keys
    )
    states = cast(states, wide_dtypes)
    alive, ptype = unpack_alive_ptype(bits[0], bits[1], p_cap)
    states = states.replace(alive=alive, ptype=ptype)
    states = states.replace(**ej_saved)
    states = states.replace(
        rng=jax.vmap(lambda k: jax.random.key_data(k).astype(jnp.uint32))(k3[:, 2]),
    )

    metrics = state_metrics(states)
    metrics["total_decay_counts"] = jnp.sum(metrics["decay_counts"], axis=0)
    metrics["total_alive"] = jnp.sum(metrics["alive"])
    return states, metrics


@functools.lru_cache(maxsize=64)
def make_decay_frame_fn(cfg: SimConfig, num_steps: int):
    """Jit-compiled :func:`decay_ensemble_step` for a (config, substep)
    bucket — the batched frame for pure decay statistics."""
    default_pdt = cfg.effective_dt()
    default_raw = cfg.physics_dt

    @functools.partial(jax.jit, donate_argnums=(0,))
    def frame(state, time_scale, frame_dt, physics_dt=default_pdt,
              raw_physics_dt=default_raw):
        return decay_ensemble_step(
            state, cfg, time_scale, frame_dt, num_steps, physics_dt,
            raw_physics_dt,
        )

    return frame


@functools.lru_cache(maxsize=64)
def make_run_fn(
    cfg: SimConfig, num_steps: int, num_frames: int, batched: bool = False
):
    """Jit-compiled *fused* run: ``num_frames`` whole frames under one
    ``lax.scan`` — one device dispatch for the whole stretch.

    Amortizes per-frame dispatch (the single-nucleus path is dispatch-bound
    otherwise) for throughput runs where the time scale is constant across
    frames. Returns ``(state, last_metrics)``; the decay chain-log ring in
    the state preserves every event for host-side draining afterwards.
    """
    fn = ensemble_step if batched else simulate_frame
    default_pdt = cfg.effective_dt()
    default_raw = cfg.physics_dt

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run(state, time_scale, frame_dt, physics_dt=default_pdt,
            raw_physics_dt=default_raw):
        def body(st, _):
            st, metrics = fn(
                st, cfg, time_scale, frame_dt, num_steps, physics_dt,
                raw_physics_dt,
            )
            return st, None

        state, _ = jax.lax.scan(body, state, None, length=num_frames)
        metrics = state_metrics(state)
        if batched:
            metrics["total_decay_counts"] = jnp.sum(metrics["decay_counts"], axis=0)
            metrics["total_alive"] = jnp.sum(metrics["alive"])
        return state, metrics

    return run


@functools.lru_cache(maxsize=128)
def make_frame_fn(cfg: SimConfig, num_steps: int, batched: bool = False):
    """Jit-compiled frame function for a (config, substep-count) bucket.

    The host driver picks ``num_steps`` per frame (nuclear_sim.py:153);
    each distinct count compiles once and is cached (<= max_substeps
    variants) — the idiomatic static-bucketing answer to the reference's
    dynamic substep loop.
    """
    fn = ensemble_step if batched else simulate_frame
    default_pdt = cfg.effective_dt()
    default_raw = cfg.physics_dt

    @functools.partial(jax.jit, donate_argnums=(0,))
    def frame(state, time_scale, frame_dt, physics_dt=default_pdt,
              raw_physics_dt=default_raw):
        return fn(
            state, cfg, time_scale, frame_dt, num_steps, physics_dt,
            raw_physics_dt,
        )

    return frame
