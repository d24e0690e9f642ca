"""Host-side simulation driver.

The accelerator-resident counterpart of the reference's ``NuclearSimulation``
(/root/reference/nuclear_sim.py:31-613): owns the static config, the device
state, the interactive time/camera controls, substep scheduling, decay-event
logging, rendering and checkpointing. All physics happens in the
jit-compiled frame functions; this class only makes host decisions (which
substep bucket to run, what to log) and keeps UI state (camera lerp, zoom).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
from collections import deque

import numpy as np

import jax

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.decay import force_decay as _force_decay
from pyqmd_tpu.core.dynamics import FrameDynamics
from pyqmd_tpu.core.init import ensemble_init, init_state
from pyqmd_tpu.core.step import make_frame_fn
from pyqmd_tpu.data.elements import element_symbol, isotope_label
from pyqmd_tpu.state import DECAY_SYMBOLS
from pyqmd_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from pyqmd_tpu.utils.format import format_time_value_with_unit
from pyqmd_tpu.utils.profiling import StepTimer

logger = logging.getLogger("pyqmd_tpu")


@jax.jit
def _status_pack(st):
    """Pack every scalar :meth:`Simulation.status` reads into ONE f32
    vector so the host fetches it in ONE readback. The per-field
    ``int(st.z)`` / ``float(st.half_life)`` form costs ~10 separate
    device-to-host syncs — per rendered frame, since the info panel reads
    status. Integer fields ride as
    bitcast f32 words (exact for all values, no 2^24 float ceiling);
    layout: [z, n, alive, ejecta, chain_cursor, decay_counts[8]] as int32
    bits, then [half_life, time_passed, rms_radius, kinetic] as f32."""
    import jax.numpy as jnp

    ints = jnp.concatenate([
        jnp.stack([
            st.z, st.n,
            st.alive_count().astype(jnp.int32),
            jnp.sum(st.ej_alive).astype(jnp.int32),
            st.chain_cursor,
        ]),
        st.decay_counts,
    ])
    floats = jnp.stack([
        st.half_life, st.time_passed, st.rms_radius(), st.kinetic_energy(),
    ]).astype(jnp.float32)
    return jnp.concatenate(
        [jax.lax.bitcast_convert_type(ints, jnp.float32), floats]
    )


@jax.jit
def _status_pack_batched(st):
    """Batched-status aggregate in one readback: [total_alive,
    decay_counts summed over the ensemble] as one int32 vector."""
    import jax.numpy as jnp

    return jnp.concatenate([
        jnp.sum(st.alive).astype(jnp.int32)[None],
        jnp.sum(st.decay_counts, axis=0).astype(jnp.int32),
    ])


@functools.partial(jax.jit, static_argnames=("width", "height"))
def _fit_frame_device(state, width, height, origin):
    """View-fitted full-frame render in ONE device program: the
    :meth:`Simulation._render_fit` camera math (alive-masked center of
    mass, max |pos - com| extent with the 5.0 floor and +3.0 margin,
    0.45·min(w, h)/extent zoom, nuclear_sim.py:68-75 semantics) computed
    in-graph, then the rasterizer's full-frame winner path (traced zoom
    selects it inside render_frame). No host transfer happens here —
    callers pipeline the returned device array."""
    import jax.numpy as jnp

    from pyqmd_tpu.render import render_frame

    w = state.alive.astype(jnp.float32)
    cnt = jnp.sum(w)
    com = jnp.where(
        cnt > 0,
        jnp.sum(state.pos * w[:, None], axis=0) / jnp.maximum(cnt, 1.0),
        origin,
    )
    d = jnp.where(w[:, None] > 0, jnp.abs(state.pos - com), 0.0)
    extent = jnp.where(
        cnt > 0, jnp.maximum(jnp.max(d), 5.0) + 3.0, 10.0
    )
    zoom = 0.45 * min(width, height) / extent
    return render_frame(
        state, (com[0], com[1]), zoom, width, height, ruler=False
    )

# Time-scale presets (nuclear_sim.py:78-87).
TIME_SCALE_PRESETS = {
    "real": 1.0,
    "minute": 60.0,
    "hour": 3600.0,
    "day": 86400.0,
    "year": 31557600.0,
    "millennium": 31557600000.0,
    "million": 31557600000000.0,
    "billion": 31557600000000000.0,
}

MIN_TIME_SCALE = 1e-40  # nuclear_sim.py:52
MAX_TIME_SCALE = 1e30  # nuclear_sim.py:53
MIN_ZOOM, MAX_ZOOM = 0.1, 100.0  # nuclear_sim.py:74-75

# Default isotope keymap (nuclear_sim.py:494-504).
ISOTOPE_KEYMAP = {
    1: (1, 2),    # H-3
    2: (2, 3),    # He-5
    3: (6, 8),    # C-14
    4: (8, 9),    # O-17
    5: (26, 33),  # Fe-59
    6: (47, 61),  # Ag-108
    7: (79, 119), # Au-198
    8: (82, 127), # Pb-209
    9: (92, 146), # U-238
}


def auto_force_backend(nucleons: int, ensemble: int | None) -> str:
    """The force backend ``"auto"`` resolves to, keyed to end-to-end
    frame rates measured on an H100 (PERF.md): the fused kernel wins for
    ensembles of 10,240 (U-238 and He-4) and for heavy nuclei from 1,024
    (U-238); the jnp step wins for a single nucleus, where one program
    per nucleus leaves most of the card idle. Off the GPU the kernel does
    not run at all."""
    if jax.default_backend() != "gpu" or not ensemble:
        return "jnp"
    if ensemble >= 10240 or (nucleons >= 128 and ensemble >= 1024):
        return "pallas"
    return "jnp"


class Simulation:
    """One nucleus (or an ensemble) plus interactive host controls."""

    def __init__(
        self,
        cfg: SimConfig | None = None,
        *,
        z: int = 92,
        n: int = 146,
        seed: int = 0,
        ensemble: int | None = None,
        pad_to: int = 128,
        force_backend: str = "auto",
        overrides: dict | None = None,
    ):
        """``overrides`` are extra SimConfig field values applied on top of
        the built config (and re-applied on isotope switches) — the
        configurable-physics surface (every reference constant is a
        SimConfig field)."""
        self.seed = seed
        self._overrides = dict(overrides or {})
        self.ensemble = ensemble
        self.pad_to = pad_to
        if force_backend == "auto":
            force_backend = auto_force_backend(z + n, ensemble)
        self.force_backend = force_backend
        # Interactive single-nucleus sims get a deeper chain ring so the
        # zero-loss log drain (see frame()) syncs every ~11 frames instead
        # of every ~2 at max substeps; ensembles keep the small ring (it is
        # per-member memory: 64k x 256 slots x 6 arrays would be 400 MB).
        self.cfg = cfg or SimConfig.for_isotope(
            z, n, pad_to=pad_to, force_backend=force_backend,
            max_chain_log=64 if ensemble else 256,
        )
        if self._overrides:
            self.cfg = dataclasses.replace(self.cfg, **self._overrides)
        self.time_scale = 1.0
        self.frame_count = 0
        self.substeps_used = 0
        # Host scheduling state (nuclear_sim.py:59-66): the physics timestep
        # and accuracy are *traced* args of the jit'd frame, so the F-key
        # auto-adjust (nuclear_sim.py:131-142) and the timestep controls
        # never recompile.
        self.physics_dt = self.cfg.physics_dt
        self.accuracy = self.cfg.accuracy
        self.max_substeps = self.cfg.max_substeps
        self.auto_adjust_substeps = False
        # Camera/zoom with lerp targets (nuclear_sim.py:68-75, 126-128).
        self.camera = [self.cfg.origin_x, self.cfg.origin_y]
        self.camera_target = list(self.camera)
        self.zoom = 15.0
        self.target_zoom = 15.0
        self.zoom_speed = 0.1
        self.chain_scroll = 0  # decay-chain panel scroll (rendering.py:528-536)
        self.info_scroll = 0  # info panel scroll lines (rendering.py:140, 534-536)
        # Default viewport size; the resize analog (nuclear_sim.py:419-428).
        self.view_width = 800
        self.view_height = 600
        self._chain_seen = 0
        self._decay_log: list[str] = []
        self._init_observability()
        self.reset()

    def _init_observability(self):
        # Frame pipelining + throughput tracking (the reference's FPS deque,
        # nuclear_sim.py:60, 119-121). Frames are dispatched without
        # blocking; a frame's *metrics* (not its donated input state) retire
        # through this queue, fenced only when they fall off the end — so up
        # to maxlen frames are in flight and the timers measure real retire
        # rate, not enqueue rate.
        self._inflight: deque = deque(maxlen=4)
        self._substep_timer = StepTimer(window=30)
        self._fps_timer = StepTimer(window=30)
        self._undrained_substeps = 0
        self._chain_cache: tuple[int, list] | None = None
        # NaN-guard readback cadence: a per-frame device->host sync would
        # stall the dispatch pipeline, so the guard reads the flag of a
        # *retired* frame every N frames.
        self.nan_check_interval = 30

    # -- lifecycle ----------------------------------------------------------

    def reset(self, z: int | None = None, n: int | None = None, seed: int | None = None):
        """(Re)build the nucleus — the create_nucleus equivalent
        (nuclear_sim.py:92-116). Resets clocks, counters, chain."""
        if z is not None or n is not None:
            z = z if z is not None else self.cfg.z
            n = n if n is not None else self.cfg.n
            self.cfg = SimConfig.for_isotope(
                z, n, pad_to=self.pad_to, force_backend=self.force_backend,
                max_chain_log=self.cfg.max_chain_log,
            )
            if self._overrides:
                self.cfg = dataclasses.replace(self.cfg, **self._overrides)
        if seed is not None:
            self.seed = seed
        if self.ensemble:
            self.state = ensemble_init(self.cfg, self.ensemble, seed=self.seed)
        else:
            self.state = init_state(self.cfg, seed=self.seed)
        self._chain_seen = 1  # skip the initial-state entry
        self._decay_log.clear()  # the old nucleus's log lines aren't ours
        self.camera_target = [self.cfg.origin_x, self.cfg.origin_y]
        self.last_metrics = None
        self._inflight.clear()
        self._substep_timer.reset()
        self._fps_timer.reset()
        self._undrained_substeps = 0
        self._chain_cache = None  # fresh ring may reuse old cursor values
        logger.info("nucleus: %s (seed %d)", self.isotope, self.seed)

    def set_isotope_key(self, key: int):
        """1-9 isotope selection (nuclear_sim.py:492-506)."""
        if key in ISOTOPE_KEYMAP:
            self.reset(*ISOTOPE_KEYMAP[key])

    @property
    def batched(self) -> bool:
        return self.state.pos.ndim == 3

    @property
    def isotope(self) -> str:
        if self.batched:
            return f"{isotope_label(self.cfg.z, self.cfg.n)} x{self.ensemble}"
        return isotope_label(int(self.state.z), int(self.state.n))

    # -- time & camera controls ---------------------------------------------

    def set_time_scale(self, value: float):
        self.time_scale = float(np.clip(value, MIN_TIME_SCALE, MAX_TIME_SCALE))
        logger.info("time scale: %g", self.time_scale)

    def scale_time(self, factor: float):
        """Arrow-key-style multiplicative change (nuclear_sim.py:437-448)."""
        self.set_time_scale(self.time_scale * factor)

    def set_preset(self, name: str):
        if name not in TIME_SCALE_PRESETS:
            raise KeyError(f"unknown preset {name!r}; options: {list(TIME_SCALE_PRESETS)}")
        self.set_time_scale(TIME_SCALE_PRESETS[name])

    def zoom_by(self, factor: float):
        self.target_zoom = float(np.clip(self.target_zoom * factor, MIN_ZOOM, MAX_ZOOM))

    def pan(self, dx: float, dy: float):
        """WASD camera pan, speed scaled by 1/zoom (nuclear_sim.py:412-417)."""
        speed = 5.0 / self.zoom
        self.camera_target[0] += dx * speed
        self.camera_target[1] += dy * speed

    def _lerp_camera(self):
        """nuclear_sim.py:126-128."""
        self.camera[0] += (self.camera_target[0] - self.camera[0]) * 0.1
        self.camera[1] += (self.camera_target[1] - self.camera[1]) * 0.1
        self.zoom += (self.target_zoom - self.zoom) * self.zoom_speed

    # -- stepping ------------------------------------------------------------

    # Substep-count ladder: in auto-adjust mode the reference allows up to
    # max_substeps * log10(time_scale) substeps (nuclear_sim.py:149-150);
    # since each count is a distinct lax.scan length (one compile each), the
    # count is snapped down to this ladder to bound jit variants. The ladder
    # applies ONLY in auto-adjust mode: with it off, counts are already
    # bounded by max_substeps (default 20) and must match the reference's
    # exact integer (nuclear_sim.py:153), so e.g. 7 substeps stay 7.
    _SUBSTEP_LADDER = (
        1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80, 100,
        128, 160, 200,
    )

    def _schedule(self, frame_dt: float) -> tuple[int, float]:
        """Host scheduling decision: (num_substeps, effective_physics_dt),
        the logic of nuclear_sim.py:131-154 including the auto-adjust mode."""
        ts = self.time_scale
        pdt = self.physics_dt
        if self.auto_adjust_substeps and ts != 1.0:
            if ts > 1.0:
                scale = min(10.0, ts**0.3)
                pdt = min(1.0 / 60.0, self.cfg.physics_dt_factor * scale / 240.0)
            else:
                scale = max(0.1, ts**0.2)
                pdt = max(1.0 / 1000.0, self.cfg.physics_dt_factor * scale / 240.0)
            self.physics_dt = pdt
        effective = pdt * (2.0 - self.accuracy)
        ts_factor = 1.0 if ts <= 10.0 else math.log10(ts)
        adj_max = (
            int(self.max_substeps * ts_factor)
            if self.auto_adjust_substeps
            else self.max_substeps
        )
        num = max(1, min(adj_max, int(frame_dt * ts / effective)))
        if self.auto_adjust_substeps:
            # Snap to the ladder (largest entry <= num) to bound compiles.
            for step in reversed(self._SUBSTEP_LADDER):
                if step <= num:
                    num = step
                    break
        return num, effective

    def frame(self, frame_dt: float = 1.0 / 60.0):
        """Advance one frame. Substep count is host-bucketed
        (nuclear_sim.py:153) and selects a cached jit variant.

        The dispatch is asynchronous: up to ``_inflight.maxlen`` frames
        pipeline on device before the host fences on a *retired* frame's
        metrics (never on the just-dispatched one), so interactive
        throughput is not bound by per-frame host round trips. The decay
        log drains lazily (on access or at the NaN-check cadence).

        Failure detection (SURVEY §5): a kernel fault raises (there is no
        fallback to another backend), and a periodic NaN guard logs
        numerical blowup instead of the reference's silent kernel-skip
        (nuclear_forces.py:222-224).
        """
        num_steps, eff_dt = self._schedule(frame_dt)
        self.substeps_used = num_steps
        if not self.batched and (
            self._undrained_substeps + num_steps >= self.cfg.max_chain_log
        ):
            # Zero-loss log drain, checked BEFORE dispatch against THIS
            # frame's actual substep count (auto-adjust frames can run up
            # to 200 substeps, far past max_substeps): the pre-frame state
            # holds every entry so far, so draining now guarantees the
            # ring cannot wrap past unseen entries.
            self._drain_chain_log()
        fn = make_frame_fn(self.cfg, num_steps, batched=self.batched)
        self.state, metrics = fn(
            self.state, self.time_scale, frame_dt, eff_dt, self.physics_dt
        )
        self.frame_count += 1
        self._retire(metrics, num_steps)
        self._lerp_camera()
        self.last_metrics = metrics
        if not self.batched:
            self._undrained_substeps += num_steps
        return metrics

    def _retire(self, metrics, num_steps: int):
        """Push this frame's metrics into the pipeline; fence on and check
        the frame that falls off the end."""
        self._inflight.append((metrics, num_steps))
        if len(self._inflight) == self._inflight.maxlen:
            old_metrics, old_steps = self._inflight.popleft()
            jax.block_until_ready(old_metrics)
            if self._substep_timer.primed:
                self._substep_timer.lap(None, steps=old_steps)
                self._fps_timer.lap(None)
            else:
                # Prime on the first retire: the span from dispatch #1 to
                # retire #1 covers the whole pipeline fill and would bias
                # the rolling rate ~3x low if credited to one frame.
                self._substep_timer.start()
                self._fps_timer.start()
        if self.nan_check_interval and (
            self.frame_count % self.nan_check_interval == 0
        ):
            self._check_nan(self._inflight[0][0])  # oldest in flight

    def _check_nan(self, metrics):
        if bool(np.any(np.asarray(metrics["nan"]))):
            logger.error(
                "non-finite state detected near frame %d (time scale %g)",
                self.frame_count, self.time_scale,
            )

    @property
    def fps(self) -> float:
        """Rolling frames/sec over retired (device-complete) frames."""
        return self._fps_timer.steps_per_sec

    @property
    def substeps_per_sec(self) -> float:
        """Rolling physics substeps/sec over retired frames."""
        return self._substep_timer.steps_per_sec

    def run(self, frames: int, frame_dt: float = 1.0 / 60.0, fused: bool = False):
        """Advance many frames. ``fused=True`` scans all frames inside one
        jit dispatch (constant time scale) — the throughput mode; the
        per-frame loop is the interactive mode (camera lerp, live logs)."""
        if not fused:
            m = self.last_metrics
            for _ in range(frames):
                m = self.frame(frame_dt)
            return m
        from pyqmd_tpu.core.step import make_run_fn

        num_steps, eff_dt = self._schedule(frame_dt)
        self.substeps_used = num_steps
        fn = make_run_fn(self.cfg, num_steps, frames, batched=self.batched)
        self.state, metrics = fn(
            self.state, self.time_scale, frame_dt, eff_dt, self.physics_dt
        )
        self.frame_count += frames
        if not self.batched:
            self._drain_chain_log()
        self.last_metrics = metrics
        return metrics

    def force_decay(self):
        """SPACE-key forced decay (nuclear_sim.py:433-434)."""
        if self.batched:
            raise RuntimeError("force_decay is for single-nucleus mode")
        dyn = FrameDynamics(
            jax.numpy.float32(self.time_scale),
            jax.numpy.float32(max(1, self.substeps_used)),
            jax.numpy.float32(self.cfg.effective_dt()),
            jax.numpy.float32(self.cfg.effective_dt() * self.time_scale),
            jax.numpy.float32(self.physics_dt),
        )
        key = jax.random.wrap_key_data(self.state.rng)
        key, sub = jax.random.split(key)
        state, _ = _force_decay(self.state, self.cfg, sub, dyn)
        self.state = state.replace(
            rng=jax.random.key_data(key).astype(jax.numpy.uint32)
        )
        self._drain_chain_log()

    # -- observability --------------------------------------------------------

    def _drain_chain_log(self, cursor: int | None = None):
        """Emit reference-style decay log lines (nuclear_sim.py:285) for new
        chain entries. Formats from :meth:`chain_entries`, which bulk-reads
        and caches the ring by cursor — so one render+drain cycle costs one
        set of device transfers, not two. ``cursor`` passes an
        already-fetched chain cursor through (status() reads it in its
        packed readback) to skip the scalar fetch."""
        self._undrained_substeps = 0
        entries = self.chain_entries(cursor=cursor)
        if not entries:
            return
        cursor = entries[-1]["index"] + 1
        if cursor == self._chain_seen:
            return
        cap = self.cfg.max_chain_log
        if cursor - self._chain_seen > cap:
            logger.warning(
                "decay log: %d entries lost (chain ring of %d wrapped "
                "between drains; raise SimConfig.max_chain_log to keep more)",
                cursor - self._chain_seen - cap, cap,
            )
        for e in entries:
            if e["index"] < self._chain_seen:
                continue
            line = (
                f"DECAY: {isotope_label(*e['parent'])}"
                f" → {isotope_label(*e['child'])}"
                f" ({e['symbol']})"
                f" after {format_time_value_with_unit(e['duration'])}"
            )
            self._decay_log.append(line)
            logger.info(line)
        self._chain_seen = cursor

    @property
    def decay_log(self) -> list[str]:
        if not self.batched:
            self._drain_chain_log()  # frames dispatch async; sync on access
        return list(self._decay_log)

    def chain_entries(self, cursor: int | None = None):
        """Decoded chain-log entries, oldest first (the decay-chain panel's
        data source, rendering.py:248-380). Bulk device readback, cached by
        cursor: the ring is append-only, so an unchanged cursor means
        unchanged content — a render+drain cycle re-reads one scalar, not
        six arrays (per-element scalar reads would cost one device sync
        each, ~384/frame). Callers that already fetched the cursor (the
        packed status readback) pass it in to skip even that scalar."""
        if self.batched:
            # Per-member rings exist but a single merged log would
            # interleave B independent chains meaninglessly; the panel
            # and decay_log already branch on batched.
            raise RuntimeError(
                "chain log is single-nucleus mode only; ensemble members "
                "decay independently (use analysis.chain_populations)"
            )
        st = self.state
        if cursor is None:
            cursor = int(st.chain_cursor)
        if self._chain_cache is not None and self._chain_cache[0] == cursor:
            return self._chain_cache[1]
        cap = self.cfg.max_chain_log
        z0 = np.asarray(st.chain_z0)
        n0 = np.asarray(st.chain_n0)
        z1 = np.asarray(st.chain_z1)
        n1 = np.asarray(st.chain_n1)
        dt_ = np.asarray(st.chain_dtype)
        tm = np.asarray(st.chain_time)
        out = []
        for c in range(max(0, cursor - cap), cursor):
            i = c % cap
            out.append(
                dict(
                    index=c,
                    parent=(int(z0[i]), int(n0[i])),
                    child=(int(z1[i]), int(n1[i])),
                    symbol=DECAY_SYMBOLS[int(dt_[i])],
                    duration=float(tm[i]),
                )
            )
        self._chain_cache = (cursor, out)
        return out

    def status(self) -> dict:
        """Info-panel data (rendering.py:135-246 equivalent).

        All device scalars arrive in ONE packed readback
        (:func:`_status_pack`) — status runs per rendered frame (the info
        panel) and per /status poll, and each separate scalar fetch is a
        device-to-host sync of its own."""
        st = self.state
        if self.batched:
            agg = np.asarray(_status_pack_batched(st))
            return dict(
                isotope=self.isotope,
                ensemble=self.ensemble,
                alive=int(agg[0]),
                decay_counts=agg[1:9].tolist(),
                time_scale=self.time_scale,
                substeps=self.substeps_used,
                fps=self.fps,
                substeps_per_sec=self.substeps_per_sec,
            )
        v = np.asarray(_status_pack(st))
        ints = v[:13].view(np.int32)
        z, n = int(ints[0]), int(ints[1])
        self._drain_chain_log(cursor=int(ints[4]))
        return dict(
            # isotope from the packed z/n (the property re-reads the
            # device scalars — two more RPCs).
            isotope=isotope_label(z, n),
            z=z,
            n=n,
            element=element_symbol(z),
            half_life=float(v[13]),
            alive=int(ints[2]),
            ejecta=int(ints[3]),
            decay_counts=ints[5:13].tolist(),
            time_passed=float(v[14]),
            time_scale=self.time_scale,
            substeps=self.substeps_used,
            physics_dt=self.physics_dt,
            auto_adjust=self.auto_adjust_substeps,
            zoom=self.zoom,
            backend=self.cfg.force_backend,
            platform=jax.default_backend(),
            fps=self.fps,
            substeps_per_sec=self.substeps_per_sec,
            rms_radius=float(v[15]),
            kinetic_energy=float(v[16]),
        )

    # -- render & persistence -------------------------------------------------

    def resize(self, width: int, height: int):
        """Set the default viewport size (the VIDEORESIZE handler analog,
        nuclear_sim.py:387-389, 419-428)."""
        self.view_width = max(16, int(width))
        self.view_height = max(16, int(height))

    def render(
        self,
        width: int | None = None,
        height: int | None = None,
        index: int = 0,
        panels: bool = True,
        controls: bool = True,
    ):
        """Rasterize the current nucleus (``index`` selects an ensemble
        member) to a host (H, W, 3) uint8 array.

        ``panels=True`` burns the info panel and the decay-chain panel into
        the frame (the reference draws both every frame,
        rendering.py:135-380): particles/ruler rasterize on device, the text
        overlay composes on host (it changes at most once per frame) and
        burns in one vectorized masked write.
        """
        from pyqmd_tpu.render import burn_overlay, compose_panels, render_to_host

        width = width or self.view_width
        height = height or self.view_height
        state = self.state
        if self.batched:
            state = jax.tree.map(lambda a: a[index], state)
        img = render_to_host(state, tuple(self.camera), self.zoom, width, height)
        if panels:
            chain = None if self.batched else self.chain_entries()
            if chain is not None:
                # Clamp the STORED scroll to the content (the reference
                # stores max_decay_scroll and clamps, rendering.py:289-292)
                # so scrolling back responds immediately after overshooting.
                # n_steps uses the same index>0 filter as draw_decay_chain
                # (after the ring wraps, the index-0 initial record is gone
                # and every returned entry counts).
                from pyqmd_tpu.render.panels import chain_scroll_limit

                n_steps = sum(1 for e in chain if e["index"] > 0)
                self.chain_scroll = min(
                    self.chain_scroll,
                    chain_scroll_limit(width, height, n_steps),
                )
            rgb, mask = compose_panels(
                width, height, self.status(), chain,
                max_substeps=self.max_substeps,
                chain_scroll=self.chain_scroll,
                info_scroll=self.info_scroll,
                controls=controls,
            )
            img = burn_overlay(img, rgb, mask)
        return img

    def render_fit_device(self, width: int, height: int, index: int = 0):
        """Device-fitted frame with NO host readback: camera fit (alive
        center of mass + extent, the :meth:`_render_fit` math) computed
        in-graph and fused with the full-frame rasterizer, returning an
        un-fenced (H, W, 3) uint8 device array. The watch loop pipelines
        these through async host copies (cli.py), so the per-frame cost
        is one overlapped readback instead of two fenced ones (the
        pos/alive readback for view fitting plus the frame itself)."""
        state = self.state
        if self.batched:
            state = jax.tree.map(lambda a: a[index], state)
        return _fit_frame_device(
            state, width, height,
            jax.numpy.asarray(
                [self.cfg.origin_x, self.cfg.origin_y], jax.numpy.float32
            ),
        )

    def _render_fit(self, width: int, height: int, index: int = 0):
        """Render with the view fitted to the nucleus extent (the REPL
        viewport; render() uses the interactive camera instead)."""
        from pyqmd_tpu.render import render_to_host

        state = self.state
        if self.batched:
            state = jax.tree.map(lambda a: a[index], state)
        alive = np.asarray(state.alive)
        pos = np.asarray(state.pos)[alive]
        if len(pos):
            com = pos.mean(0)
            extent = max(float(np.abs(pos - com).max()), 5.0) + 3.0
        else:
            com, extent = np.array([self.cfg.origin_x, self.cfg.origin_y]), 10.0
        zoom = 0.45 * min(width, height) / extent
        return render_to_host(
            state, (float(com[0]), float(com[1])), zoom, width, height, ruler=False
        )

    def render_grid(self, nx: int = 4, ny: int = 4, tile: int = 120):
        """Montage of the first nx*ny ensemble members, each view-fitted —
        population-level visual inspection (no reference equivalent)."""
        if not self.batched:
            raise RuntimeError("render_grid is for ensemble mode")
        count = min(nx * ny, self.state.pos.shape[0])
        rows = []
        for j in range(ny):
            row = []
            for i in range(nx):
                k = j * nx + i
                if k < count:
                    img = self._render_fit(tile, tile, index=k)
                else:
                    img = np.zeros((tile, tile, 3), np.uint8)
                img = img.copy()
                img[0, :] = img[:, 0] = 40  # tile border
                row.append(img)
            rows.append(np.concatenate(row, axis=1))
        return np.concatenate(rows, axis=0)

    def render_ansi(self, width: int = 72, height: int = 48, index: int = 0) -> str:
        """Truecolor terminal view (two pixels per character row)."""
        from pyqmd_tpu.render.ansi import ansi_render

        return ansi_render(self._render_fit(width, height, index))

    def render_ascii(self, width: int = 72, height: int = 30, index: int = 0) -> str:
        """Terminal view: the interactive-display analog for the REPL.
        Protons 'o', neutrons '.', ejecta by type letter. Fits the view to
        the nucleus (unlike render(), which uses the interactive camera)."""
        img = self._render_fit(width, height, index).astype(np.int32)
        # Classify by dominant channel of the rasterized pixel — one
        # vectorized np.select instead of a per-pixel Python loop (the loop
        # was ~5 ms per 72x30 view and scaled with the viewport).
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        classes = np.select(
            [
                (r == 0) & (g == 0) & (b == 0),
                (r > 200) & (g < 180) & (b < 180),  # proton reds
                (b > 200) & (r < 180),              # neutron blues
                (r > 150) & (g > 150) & (b < 100),  # alpha yellow
                (g > 150) & (r < 100) & (b > 150),  # electron cyan
                (g > 150) & (r < 100),              # gamma green
                (r > 150) & (b > 150),              # positron magenta
            ],
            np.arange(7, dtype=np.uint8),
            default=7,
        )
        glyphs = np.frombuffer(b" o.aeyp#", dtype=np.uint8)
        rows = glyphs[classes]
        return "\n".join(bytes(row).decode("ascii") for row in rows)

    def save(self, path: str):
        save_checkpoint(path, self.state, self.cfg)
        logger.info("saved checkpoint: %s", path)

    @classmethod
    def load(cls, path: str) -> "Simulation":
        state, cfg = load_checkpoint(path)
        sim = cls.__new__(cls)
        sim.cfg = cfg
        sim.seed = 0
        sim._overrides = {}
        sim.pad_to = cfg.max_particles
        sim.force_backend = cfg.force_backend
        sim.state = state
        sim.ensemble = state.pos.shape[0] if state.pos.ndim == 3 else None
        sim.time_scale = 1.0
        sim.frame_count = 0
        sim.substeps_used = 0
        sim.physics_dt = cfg.physics_dt
        sim.accuracy = cfg.accuracy
        sim.max_substeps = cfg.max_substeps
        sim.auto_adjust_substeps = False
        sim.camera = [cfg.origin_x, cfg.origin_y]
        sim.camera_target = list(sim.camera)
        sim.zoom = 15.0
        sim.target_zoom = 15.0
        sim.zoom_speed = 0.1
        sim.chain_scroll = 0
        sim.info_scroll = 0
        sim.view_width = 800
        sim.view_height = 600
        sim._chain_seen = int(state.chain_cursor) if state.pos.ndim == 2 else 0
        sim._decay_log = []
        sim.last_metrics = None
        sim._init_observability()
        return sim
