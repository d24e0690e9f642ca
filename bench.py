"""Benchmark harness — prints progressive JSON result lines; the LAST
complete line is the result (earlier lines are partial snapshots so a
killed cold-cache run still records its headline).

Headline: U-238 full-physics nucleus-substeps per second on a 10k-nucleus
ensemble (force + integrate + decay sampling + ejecta, the complete substep
path), on whichever force backend (jnp / pallas) is faster.

Baseline: the reference can execute at most 1200 force substeps per second
on its single nucleus — 60 fps cap x 20 max substeps
(/root/reference/nuclear_sim.py:59, 63, 594) — and that ceiling is
structural (blocking host<->device round trip per substep,
nuclear_forces.py:202-234). ``vs_baseline`` is the ratio of our per-chip
nucleus-substeps/s to that 1200/s figure. A measured datum for the
reference's *CPU fallback* physics (same O(N^2) double loop, pure Python)
is included in extras.

The run refuses to start without an NVIDIA GPU, and every line names the
device as JAX reports it, the card and its power limit. This is the
harness carried over as-is; the GPU benchmark with repeated windows,
per-layer spans and a regression bound is ROADMAP S1.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

import jax

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.forces import force_step_scalar
from pyqmd_tpu.core.init import ensemble_init, init_state
from pyqmd_tpu.core.step import make_frame_fn
from pyqmd_tpu.utils.compile_cache import enable_compile_cache
from pyqmd_tpu.utils.device import card_info, device_fields, require_gpu

FRAME_DT = 1.0 / 60.0
NUM_STEPS = 20  # the reference's max substeps per frame


def bench_ensemble(z, n, batch, backend, frames=5, pad_to=128):
    """Time `frames` full frames of a `batch`-nucleus ensemble; returns
    nucleus-substeps per second.

    Methodology: frames dispatch back-to-back (each one's output state is
    the next one's donated input, so device execution is a serialized
    dependency chain) and the clock stops on a host readback of the LAST
    state, which fences the whole chain. This is the interactive dispatch
    pattern (one program per frame), not the fused-scan throughput mode.
    """
    cfg = SimConfig.for_isotope(z, n, pad_to=pad_to, force_backend=backend)
    states = ensemble_init(cfg, batch, seed=0) if batch > 1 else init_state(cfg, seed=0)
    fn = make_frame_fn(cfg, NUM_STEPS, batched=batch > 1)
    states, m = fn(states, 1.0, FRAME_DT)  # compile + warmup
    np.asarray(states.z)  # hard fence (small leaf: O(B) bytes, not O(B*P))
    t0 = time.perf_counter()
    for _ in range(frames):
        states, m = fn(states, 1.0, FRAME_DT)
    np.asarray(states.z)  # fences the full dependent chain
    dt = time.perf_counter() - t0
    return frames * NUM_STEPS * batch / dt


def bench_python_reference(z=92, n=146, steps=10, reps=5):
    """Measured datum: the reference CPU-fallback physics (pure-Python
    O(N^2), nuclear_forces.py:236-323) on this machine.

    Best-of-``reps`` over ``steps``-step runs: the r4 verdict (weak #6)
    flagged that a single 3-step timing swung 15.47 → 10.13 steps/s
    between rounds, making the cross-round multiplier incomparable. The
    frozen companion datum lives in BASELINE.json ``measured`` and is
    reported alongside this fresh one.
    """
    cfg = SimConfig.for_isotope(z, n, pad_to=8)
    st = init_state(cfg, seed=0)
    pos = np.asarray(st.pos).tolist()
    vel = np.asarray(st.vel).tolist()
    ptype = np.asarray(st.ptype).tolist()
    alive = np.asarray(st.alive).tolist()
    best = 0.0
    for _ in range(reps):
        p, v = pos, vel
        t0 = time.perf_counter()
        for _ in range(steps):
            p, v = force_step_scalar(p, v, ptype, alive, 1 / 240, cfg)
        best = max(best, steps / (time.perf_counter() - t0))
    return best


def bench_fused_single(backend="jnp", frames_per_dispatch=50, reps=4):
    """Single-nucleus throughput with frame-fused dispatch (the reference's
    literal workload: one U-238 nucleus). One jit dispatch = 50 frames x 20
    substeps, amortizing host dispatch latency."""
    from pyqmd_tpu.core.step import make_run_fn

    cfg = SimConfig.for_isotope(92, 146, pad_to=128, force_backend=backend)
    state = init_state(cfg, seed=0)
    fn = make_run_fn(cfg, NUM_STEPS, frames_per_dispatch)
    state, m = fn(state, 1.0, FRAME_DT)
    np.asarray(state.z)  # hard fence
    t0 = time.perf_counter()
    for _ in range(reps):
        state, m = fn(state, 1.0, FRAME_DT)
    np.asarray(state.z)  # ground-truth fence of the dependent chain
    dt = time.perf_counter() - t0
    return reps * frames_per_dispatch * NUM_STEPS / dt


def bench_halflife_accuracy(batch=32768, frames=20, decay_only=False):
    """BASELINE acceptance bar: C-14 ensemble half-life within 1%.

    Runs `batch` C-14 nuclei for 2 tabulated half-lives and MLE-fits the
    half-life from the survivor count. Statistical error at this ensemble
    size is ~0.7%, so a healthy run lands within 1%.

    ``decay_only=True`` uses the statistics-only frame (bitwise-identical
    isotope trajectories, no O(P²) forces), making million-nucleus
    ensembles cheap — statistical error ~0.1% at batch=2**21.
    """
    import math

    from pyqmd_tpu.core.step import make_decay_frame_fn

    hl_true = 5730 * 31557600.0
    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    states = ensemble_init(cfg, batch, seed=0)
    fn = (
        make_decay_frame_fn(cfg, 10)
        if decay_only
        else make_frame_fn(cfg, 10, batched=True)
    )
    sim_dt = 0.1 * hl_true  # per frame, over 10 substeps
    for _ in range(frames):
        states, m = fn(states, sim_dt, 1.0)
    surv = float(
        np.asarray((m["z"] == 6) & (m["n"] == 8)).sum()
    ) / batch
    if surv >= 1.0:  # zero decays: -log(1.0) = -0.0 would divide by zero
        return math.inf
    fit_hl = math.log(2) * (frames * sim_dt) / -math.log(max(surv, 1e-9))
    return abs(fit_hl - hl_true) / hl_true


def bench_decay_only_throughput(batch=1 << 21, frames=4, substeps=10, reps=3):
    """Decay-only statistics frame throughput: the O(B·P) half-life
    machinery. Same fencing protocol as bench_ensemble; best-of-``reps``
    windows."""
    from pyqmd_tpu.core.step import make_decay_frame_fn

    hl_true = 5730 * 31557600.0
    # Ring of 8 = the analysis-workflow default (statistics never read the
    # chain log).
    cfg = SimConfig.for_isotope(6, 8, pad_to=8, max_chain_log=8)
    states = ensemble_init(cfg, batch, seed=0)
    fn = make_decay_frame_fn(cfg, substeps)
    sim_dt = 0.01 * hl_true  # slow enough that most of the run has decays left
    states, m = fn(states, sim_dt, 1.0)  # compile + warmup
    np.asarray(states.z)
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(frames):
            states, m = fn(states, sim_dt, 1.0)
        np.asarray(states.z)
        best = max(best, frames * substeps * batch / (time.perf_counter() - t0))
    return best


def bench_sharded(frames=3):
    """shard_map + psum + ppermute on a mesh of every available GPU.
    Returns (frame_substeps_per_sec, ring_max_abs_diff)."""
    from pyqmd_tpu.parallel.ensemble import make_sharded_frame_fn
    from pyqmd_tpu.parallel.mesh import make_mesh, shard_ensemble
    from pyqmd_tpu.parallel.ring import make_ring_force_step

    mesh = make_mesh()  # every available device
    batch = 1024 * mesh.devices.size
    cfg = SimConfig.for_isotope(92, 146, pad_to=128)
    states = shard_ensemble(ensemble_init(cfg, batch, seed=0), mesh)
    fn = make_sharded_frame_fn(cfg, NUM_STEPS, mesh)
    states, m = fn(states, 1.0, FRAME_DT)
    np.asarray(m["survivors"])  # execution fence (psum output)
    t0 = time.perf_counter()
    for _ in range(frames):
        states, m = fn(states, 1.0, FRAME_DT)
    np.asarray(m["survivors"])
    rate = frames * NUM_STEPS * batch / (time.perf_counter() - t0)

    # Particle-axis ppermute ring on a model mesh: the sharded force
    # sweep must match the dense jnp step.
    ring_mesh = make_mesh(axis_names=("model",))
    st = init_state(cfg, seed=0)
    ring_step = make_ring_force_step(cfg, ring_mesh, axis="model")
    rp, rv = ring_step(st.pos, st.vel, st.ptype, st.alive, cfg.effective_dt())
    from pyqmd_tpu.core.forces import force_step

    jp, jv = jax.jit(
        lambda *a: force_step(*a, cfg.effective_dt(), cfg)
    )(st.pos, st.vel, st.ptype, st.alive)
    ring_diff = float(
        max(
            np.abs(np.asarray(rp) - np.asarray(jp)).max(),
            np.abs(np.asarray(rv) - np.asarray(jv)).max(),
        )
    )
    return rate, ring_diff


def bench_render(fps_frames=60):
    """Render throughput (fps) at 800x600.

    Same methodology as bench_ensemble: frames dispatch back-to-back and
    the clock stops on a host readback of the LAST image (programs run in
    order, so it fences every frame). The interactive number (the
    reference's PyGame loop displays at 60 fps, nuclear_sim.py:594) is
    the palettized, pipelined path of render/interactive.py, every frame
    landing on the host; the serial full-RGB readback rate is beside it.

    Returns (fps, interactive_fps, rgb_readback_fps, packed_exact).
    """
    from pyqmd_tpu.render import (
        PipelinedFrameReader, render_frame, render_frame_packed, unpack_frame,
    )

    cfg = SimConfig.for_isotope(92, 146, pad_to=128)
    st = init_state(cfg, seed=0)
    img = render_frame(st, (400.0, 400.0), 10.0, 800, 600)
    np.asarray(img)  # compile + hard fence
    t0 = time.perf_counter()
    for _ in range(fps_frames):
        img = render_frame(st, (400.0, 400.0), 10.0, 800, 600)
    np.asarray(img)  # FIFO order: fences every frame above
    fps = fps_frames / (time.perf_counter() - t0)

    # Interactive pipeline: packed frame per iteration, previous frame's
    # RGB expanded on host. Delivered = n (the last drains in flush()).
    packed = render_frame_packed(st, (400.0, 400.0), 10.0, 800, 600)
    rgb0 = unpack_frame(np.asarray(packed))  # compile + warm + exactness
    exact = rgb0 is not None and np.array_equal(rgb0, np.asarray(img))
    # Best-of-3 windows.
    n_i = max(10, fps_frames // 2)
    ifps = 0.0
    for _ in range(3):
        reader = PipelinedFrameReader()
        delivered = 0
        t0 = time.perf_counter()
        for _ in range(n_i):
            out = reader.submit(
                render_frame_packed(st, (400.0, 400.0), 10.0, 800, 600)
            )
            delivered += out is not None
        delivered += len(reader.flush())
        ifps = max(ifps, delivered / (time.perf_counter() - t0))

    n_rb = max(5, fps_frames // 12)
    t0 = time.perf_counter()
    for _ in range(n_rb):
        img = render_frame(st, (400.0, 400.0), 10.0, 800, 600)
        np.asarray(img)
    rb_fps = n_rb / (time.perf_counter() - t0)
    return fps, ifps, rb_fps, exact


def _best_b10240(results):
    """Key of the fastest 10k-ensemble measurement (the headline)."""
    return max(
        (k for k in results if k.endswith("b10240")),
        key=lambda k: results[k],
        default=None,
    )


def _emit(results, extras):
    """Print the result line with everything gathered SO FAR. Called after
    each major section as well as at the end: the LAST complete JSON line
    is the result, so a run killed mid-way still records its headline."""
    value = results.get(_best_b10240(results), 0.0)
    print(
        json.dumps(
            {
                "metric": "u238_10k_ensemble_nucleus_substeps_per_sec",
                "value": round(value, 1),
                "unit": "nucleus-substeps/s",
                "vs_baseline": round(value / 1200.0, 1),
                "extra": extras,
            }
        ),
        flush=True,
    )


def main():
    devices = require_gpu()
    enable_compile_cache()
    # Every line names the device and the card: a card set below its
    # maximum power limit runs slower under load.
    extras = {"device": device_fields(devices), **card_info()}

    # Fresh measurement AND the frozen datum (BASELINE.json "measured"):
    # the fresh one tracks this machine today, the frozen one keeps the
    # multiplier on a shared denominator.
    extras["python_reference_steps_per_sec"] = round(bench_python_reference(), 2)
    try:
        with open(
            os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE.json")
        ) as f:
            extras["python_reference_steps_per_sec_frozen"] = json.load(f)[
                "measured"
            ]["python_reference_steps_per_sec"]
    except Exception:
        pass

    results = {}
    for backend in ("jnp", "pallas"):
        try:
            # More frames at small batches to amortize the single
            # end-of-chain readback.
            for batch, frames in ((1, 100), (1024, 10), (10240, 5)):
                key = f"u238_{backend}_b{batch}"
                results[key] = bench_ensemble(92, 146, batch, backend, frames=frames)
                extras[key + "_nucleus_substeps_per_sec"] = round(results[key])
        except Exception as e:  # a backend failing must not kill the bench
            extras[f"{backend}_error"] = f"{type(e).__name__}: {e}"[:200]
        _emit(results, extras)  # partial line: headline known per backend

    # 64k-nucleus config (BASELINE bench matrix) on the faster backend.
    best10k = _best_b10240(results)
    if best10k:
        backend = best10k.split("_")[1]
        try:
            v = bench_ensemble(92, 146, 65536, backend, frames=4)
            extras[f"u238_{backend}_b65536_nucleus_substeps_per_sec"] = round(v)
            results[f"u238_{backend}_b65536"] = v
        except Exception as e:
            extras["b65536_error"] = f"{type(e).__name__}: {e}"[:200]

    # 64k ensemble init time (pool method). Warm number: the compile is
    # in the persistent cache.
    try:
        st0 = ensemble_init(
            SimConfig.for_isotope(92, 146, pad_to=128), 65536, seed=0
        )
        np.asarray(st0.z)
        t0 = time.perf_counter()
        st0 = ensemble_init(
            SimConfig.for_isotope(92, 146, pad_to=128), 65536, seed=1
        )
        np.asarray(st0.z)
        extras["init_64k_seconds"] = round(time.perf_counter() - t0, 2)
        del st0
    except Exception as e:
        extras["init_error"] = f"{type(e).__name__}: {e}"[:200]

    # He-4 small-nucleus throughput, both backends (the kernel groups
    # several He-4 nuclei per program). Completes the BASELINE bench
    # matrix {He-4, U-238} x {1, 1k, 10k, 64k}.
    for backend in ("jnp", "pallas"):
        for batch, frames in ((1, 100), (1024, 10), (10240, 5), (65536, 2)):
            try:
                extras[f"he4_{backend}_b{batch}_nucleus_substeps_per_sec"] = round(
                    bench_ensemble(2, 2, batch, backend, frames=frames, pad_to=8)
                )
            except Exception as e:
                extras[f"he4_{backend}_b{batch}_error"] = f"{type(e).__name__}: {e}"[:200]
    _emit(results, extras)  # partial line: full throughput matrix done

    # Decay-only statistics throughput at 2M nuclei.
    try:
        extras["c14_decay_only_b2m_nucleus_substeps_per_sec"] = round(
            bench_decay_only_throughput()
        )
    except Exception as e:
        extras["decay_only_error"] = f"{type(e).__name__}: {e}"[:200]

    # Sharded paths on a mesh of every available GPU.
    try:
        rate, ring_diff = bench_sharded()
        extras["sharded_frame_ok"] = True
        extras["sharded_frame_nucleus_substeps_per_sec"] = round(rate)
        extras["ring_force_max_abs_diff"] = ring_diff
        extras["ring_force_ok"] = ring_diff < 1e-3
    except Exception as e:
        extras["sharded_frame_ok"] = False
        extras["sharded_error"] = f"{type(e).__name__}: {e}"[:200]
    _emit(results, extras)

    try:
        fps, ifps, rb_fps, exact = bench_render()
        extras["render_fps_800x600"] = round(fps, 1)
        extras["render_fps_with_per_frame_readback"] = round(ifps, 1)
        extras["render_fps_serial_rgb_readback"] = round(rb_fps, 1)
        extras["render_packed_exact"] = bool(exact)
    except Exception as e:
        extras["render_error"] = f"{type(e).__name__}: {e}"[:200]

    try:
        extras["c14_halflife_rel_error_32k"] = round(bench_halflife_accuracy(), 5)
    except Exception as e:
        extras["halflife_error"] = f"{type(e).__name__}: {e}"[:200]

    # Million-nucleus statistics via the decay-only frame (forces skipped;
    # isotope trajectories bitwise-identical — see decay_ensemble_step).
    try:
        extras["c14_halflife_rel_error_2m_decay_only"] = round(
            bench_halflife_accuracy(batch=1 << 21, decay_only=True), 5
        )
    except Exception as e:
        extras["halflife_2m_error"] = f"{type(e).__name__}: {e}"[:200]

    try:
        extras["u238_b1_fused_substeps_per_sec"] = round(bench_fused_single())
    except Exception as e:
        extras["fused_error"] = f"{type(e).__name__}: {e}"[:200]

    _emit(results, extras)  # final line: everything


if __name__ == "__main__":
    main()
