"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py          # one card: every phase below
    python chip_smoke.py --four   # four cards: the sharded ensemble only

Each phase prints one JSON line with the card's name and power limit;
the last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
The script exits non-zero, without that line, when JAX finds no GPU or
any phase fails. It never falls back to the CPU.

Phases (one card), at the sizes users run:

1. session — the reference's own workload through the CLI
   (``cli.main``, in-process): one U-238 nucleus for 400 frames at a time
   scale that completes the chain, rendered to PNG. The nucleus must end
   as Pb-206 after 8 alpha and 6 beta-minus decays.
2. ensemble — full-physics ``Simulation`` ensembles of 10,240 U-238 and
   10,240 He-4 nuclei, 20 substeps per frame, with the jnp force step and
   the fused kernel timed in turns in this one process. Also the jnp
   overlap pass's share of a U-238 frame.
3. forces — on the settled U-238 batch: the jnp step against the
   float64 scalar reference on 4 members, and the kernel against the jnp
   step over the whole batch.
4. statistics — C-14 survival over 2 half-lives at 2,097,152 nuclei
   through the CLI (fitted half-life within 1%), and the decay-only frame
   against the full-physics frame on U-238 b1024 (isotopes bitwise equal).
5. render — 800x600: the palettized frame equals the RGB frame byte
   for byte.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

import jax

FRAME_DT = 1.0 / 60.0
SUBSTEPS = 20
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")


def fence(tree):
    jax.block_until_ready(tree)
    return tree


class Report:
    """Runs phases, prints one JSON line each, remembers failures."""

    def __init__(self, card: dict):
        self.card = card
        self.failed = []

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            result = fn(*args)
            line = {"phase": name, "ok": True, **self.card, **result}
        except Exception as e:  # a failed phase is reported, then fails the run
            result = None
            self.failed.append(name)
            line = {"phase": name, "ok": False, **self.card,
                    "error": f"{type(e).__name__}: {e}"[:2000]}
        line["phase_seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        return result


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# -- phase 1 ----------------------------------------------------------------

def phase_session():
    from pyqmd_tpu import cli
    from pyqmd_tpu.state import DECAY_ALPHA, DECAY_BETA_MINUS

    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "u238.png")
    # 1e12 yr per wall second: U-238 decays with p ~ 0.12 per substep, its
    # daughters faster still, so the 8000 substeps complete the chain.
    argv = [
        "--platform", "cuda", "--isotope", "U-238", "--frames", "400",
        "--time-scale", "1e12yr", "--status-json", "--render", png, "-q",
    ]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    status = json.loads(buf.getvalue().strip().splitlines()[-1])
    counts = status["decay_counts"]
    check(rc == 0, f"cli returned {rc}")
    check((status["z"], status["n"]) == (82, 124), f"ended as {status['isotope']}")
    check(counts[DECAY_ALPHA] == 8 and counts[DECAY_BETA_MINUS] == 6,
          f"decay counts {counts}")
    check(sum(counts) == 14, f"extra decays {counts}")
    check(os.path.getsize(png) > 0, "no PNG written")
    return {
        "isotope": status["isotope"], "decay_counts": counts,
        "substeps_per_s": status["substeps_per_sec"],
        "fps": status["fps"], "wall_s_incl_compile": wall,
    }


# -- phase 2 ----------------------------------------------------------------

def _ensemble(z, n, pad_to, backend, batch):
    from pyqmd_tpu.sim import Simulation

    sim = Simulation(z=z, n=n, ensemble=batch, pad_to=pad_to,
                     force_backend=backend)
    sim.set_time_scale(10.0)  # 20 substeps per 1/60 s frame, no decays
    sim.frame(FRAME_DT)  # compile + warm
    fence(sim.state)
    return sim


def _window(sim, frames=5):
    t0 = time.perf_counter()
    for _ in range(frames):
        sim.frame(FRAME_DT)
    fence(sim.state)
    dt = time.perf_counter() - t0
    return frames * SUBSTEPS * sim.ensemble / dt


def _overlap_share(sim, frame_rate):
    """Seconds of the jnp overlap pass over seconds of one whole frame."""
    from pyqmd_tpu.core.step import _batched_overlap

    st = sim.state
    b = st.pos.shape[0]
    keys = jax.vmap(jax.random.key)(jax.numpy.arange(b, dtype=jax.numpy.uint32))
    fn = jax.jit(lambda p, a, k: _batched_overlap(p, a, k, sim.cfg))
    fence(fn(st.pos, st.alive, keys))
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(st.pos, st.alive, keys)
    fence(out)
    overlap_s = (time.perf_counter() - t0) / reps
    frame_s = SUBSTEPS * b / frame_rate
    return overlap_s / frame_s


def phase_ensemble(ctx, batch=10240):
    """Full-physics frames for U-238 and He-4, jnp and kernel in turns
    (jnp, kernel, kernel, jnp, jnp, kernel). Leaves the settled U-238
    batch in ``ctx["settled"]`` for the force check."""
    out = {"batch": batch, "substeps_per_frame": SUBSTEPS}
    for label, z, n, pad_to in (("u238", 92, 146, 128), ("he4", 2, 2, 8)):
        sims = {b: _ensemble(z, n, pad_to, b, batch) for b in ("jnp", "pallas")}
        alive0 = int(sims["jnp"].state.alive.sum())
        rates = {"jnp": [], "pallas": []}
        for b in ("jnp", "pallas", "pallas", "jnp", "jnp", "pallas"):
            rates[b].append(_window(sims[b]))
        for b, sim in sims.items():
            st = sim.state
            check(bool(np.isfinite(np.asarray(st.pos)).all()
                       and np.isfinite(np.asarray(st.vel)).all()),
                  f"{label} {b}: non-finite state")
            check(int(st.alive.sum()) == alive0, f"{label} {b}: alive count moved")
        for b in rates:
            out[f"{label}_{b}_nucleus_substeps_per_s"] = float(np.median(rates[b]))
            out[f"{label}_{b}_windows"] = rates[b]
        if label == "u238":
            out["u238_overlap_share_of_jnp_frame"] = _overlap_share(
                sims["jnp"], out["u238_jnp_nucleus_substeps_per_s"]
            )
            ctx["settled"] = (sims["jnp"].cfg, sims["jnp"].state)
        del sims
    out["peak_bytes_in_use"] = (jax.devices()[0].memory_stats() or {}).get(
        "peak_bytes_in_use"
    )
    return out


# -- phase 3 ----------------------------------------------------------------

def phase_forces(ctx):
    """Force step correctness at real width on a settled U-238 batch.

    Tolerances: the jnp step against the float64 scalar reference within
    1e-4 (float32 sums of <= 255 clamped terms, each <= 12); the kernel
    against the jnp step within 1e-5, relative to the value where it
    exceeds 1 (positions near 400 are spaced 3.05e-5 apart in float32, so
    an absolute 1e-5 there would demand bitwise equality).

    The force law has steps (the pair cuts and the center-of-mass
    spring's 1.5 R threshold). A nucleon within float32 rounding of a
    step lands on either side depending on summation order, so a few
    such ties are allowed — at most one element in 10^6 — if, at each,
    one of the two steps matches the float64 reference within 1e-4 and
    the other differs from it by no more than one term's jump."""
    from pyqmd_tpu.core.forces import force_step, force_step_scalar
    from pyqmd_tpu.kernels.forces_pallas import force_step_pallas

    cfg, st = ctx["settled"]
    dt = cfg.effective_dt()
    args = (st.pos, st.vel, st.ptype, st.alive)
    with jax.default_matmul_precision("highest"):
        jp, jv = fence(jax.jit(lambda *a: force_step(*a, dt, cfg))(*args))
    kp, kv = fence(jax.jit(lambda *a: force_step_pallas(*a, dt, cfg))(*args))
    jnp_out = np.stack([np.asarray(jp), np.asarray(jv)])  # (2, B, P, 2)
    ker_out = np.stack([np.asarray(kp), np.asarray(kv)])
    host = [np.asarray(a) for a in args]

    def scalar(i):
        sp, sv = force_step_scalar(
            host[0][i].astype(np.float64).tolist(),
            host[1][i].astype(np.float64).tolist(),
            host[2][i].tolist(), host[3][i].tolist(), dt, cfg,
        )
        return np.stack([np.asarray(sp), np.asarray(sv)])  # (2, P, 2)

    b = jnp_out.shape[1]
    members = sorted({0, b // 3, (2 * b) // 3, b - 1})
    scalar_err = 0.0
    for i in members:
        alive = host[3][i]
        err = np.abs(jnp_out[:, i] - scalar(i))[:, alive]
        scalar_err = max(scalar_err, float(err.max()))

    scaled = np.abs(ker_out - jnp_out) / np.maximum(1.0, np.abs(jnp_out))
    off = np.argwhere(scaled > 1e-5)  # (k, i, j, c) of each element
    jump = 2 * cfg.max_pair_force * dt
    ties = []
    for i in sorted({int(e[1]) for e in off}):
        ref = scalar(i)
        for k, _, j, c in off[off[:, 1] == i]:
            errs = sorted((abs(ker_out[k, i, j, c] - ref[k, j, c]),
                           abs(jnp_out[k, i, j, c] - ref[k, j, c])))
            ties.append({"member": i, "slot": int(j), "field": ("pos", "vel")[k],
                         "component": int(c), "near_side_err": float(errs[0]),
                         "far_side_err": float(errs[1])})
            check(errs[0] <= 1e-4 and errs[1] <= jump,
                  f"kernel vs jnp at member {i} slot {j}: {errs}")
    check(scalar_err <= 1e-4, f"jnp vs scalar {scalar_err}")
    check(len(off) <= ker_out.size // 10**6, f"{len(off)} elements differ")
    within = scaled.copy()
    within[tuple(off.T)] = 0.0
    return {
        "members_vs_scalar": members,
        "jnp_vs_scalar_max_abs": scalar_err,
        "kernel_vs_jnp_max_abs": float(np.abs(ker_out - jnp_out).max()),
        "kernel_vs_jnp_max_scaled_outside_ties": float(within.max()),
        "elements_compared": int(ker_out.size),
        "ties_at_force_law_steps": ties,
    }


# -- phase 4 ----------------------------------------------------------------

def phase_statistics(batch=1 << 21):
    from pyqmd_tpu import cli
    from pyqmd_tpu.config import SimConfig
    from pyqmd_tpu.core.init import ensemble_init
    from pyqmd_tpu.core.step import make_decay_frame_fn, make_frame_fn

    os.makedirs(OUT_DIR, exist_ok=True)
    csv = os.path.join(OUT_DIR, "c14_survival.csv")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--platform", "cuda", "--isotope", "C-14",
                       "--ensemble", str(batch), "--survival", csv,
                       "--half-lives", "2", "-q"])
    wall = time.perf_counter() - t0
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0, f"cli returned {rc}")
    check(summary["rel_error"] <= 0.01, f"half-life error {summary['rel_error']}")

    # Warm rate of the same decay-only frame (the CLI's run includes
    # initialization and compilation): 20 frames of 10 substeps.
    cfg = SimConfig.for_isotope(6, 8, pad_to=8, max_chain_log=8)
    fn = make_decay_frame_fn(cfg, 10)
    states = ensemble_init(cfg, batch, seed=1)
    hl = 5730 * 31557600.0
    states, _ = fn(states, 0.1 * hl, 1.0)
    fence(states)
    t0 = time.perf_counter()
    for _ in range(20):
        states, m = fn(states, 0.1 * hl, 1.0)
    fence(states)
    rate = 20 * 10 * batch / (time.perf_counter() - t0)
    del states

    # Decay-only frame against the full-physics frame: same isotopes.
    ucfg = SimConfig.for_isotope(92, 146, pad_to=128)
    ts = 3.15576e19  # 1e12 yr/s: decays fire within the first frame
    full_fn = make_frame_fn(ucfg, SUBSTEPS, batched=True)
    decay_fn = make_decay_frame_fn(ucfg, SUBSTEPS)
    full = ensemble_init(ucfg, 1024, seed=2)
    only = ensemble_init(ucfg, 1024, seed=2)
    for _ in range(3):
        full, _ = full_fn(full, ts, FRAME_DT)
        only, _ = decay_fn(only, ts, FRAME_DT)
    events = int(np.asarray(full.decay_counts).sum())
    check(events > 0, "no decays fired")
    for f in ("z", "n", "decay_counts"):
        check(np.array_equal(np.asarray(getattr(full, f)),
                             np.asarray(getattr(only, f))), f"{f} differs")
    return {
        "c14_batch": batch, "c14_fitted_half_life_rel_error": summary["rel_error"],
        "c14_cli_wall_s_incl_compile": wall,
        "c14_decay_only_nucleus_substeps_per_s": rate,
        "u238_b1024_decay_only_equals_full_physics": True,
        "u238_b1024_events": events,
    }


# -- phase 5 ----------------------------------------------------------------

def phase_render(frames=60):
    from pyqmd_tpu.config import SimConfig
    from pyqmd_tpu.core.init import init_state
    from pyqmd_tpu.render import render_frame, render_frame_packed, unpack_frame

    st = init_state(SimConfig.for_isotope(92, 146, pad_to=128), seed=0)
    cam = (400.0, 400.0)
    rgb = np.asarray(render_frame(st, cam, 10.0, 800, 600))
    packed = unpack_frame(np.asarray(render_frame_packed(st, cam, 10.0, 800, 600)))
    check(packed is not None and np.array_equal(packed, rgb),
          "palettized frame differs from RGB frame")
    t0 = time.perf_counter()
    for _ in range(frames):
        img = render_frame(st, cam, 10.0, 800, 600)
    fence(img)
    return {"size": "800x600", "render_ms_per_frame":
            1e3 * (time.perf_counter() - t0) / frames, "palettized_exact": True}


# -- four cards -------------------------------------------------------------

def phase_four(batch_full=40960, batch_decay=1 << 21):
    """The data-parallel ensemble on a 4-card mesh against one card."""
    from pyqmd_tpu.config import SimConfig
    from pyqmd_tpu.core.init import ensemble_init
    from pyqmd_tpu.core.step import make_decay_frame_fn, make_frame_fn
    from pyqmd_tpu.parallel import (
        make_mesh, make_sharded_decay_fn, make_sharded_frame_fn, shard_ensemble,
    )

    mesh = make_mesh()
    check(mesh.devices.size == 4, f"mesh of {mesh.devices.size} devices")
    out = {"mesh": {k: int(v) for k, v in mesh.shape.items()}}
    one = jax.devices()[0]
    cases = (
        # label, (z, n, pad_to, max_chain_log), batch, time scale, sharded
        # builder, one-card builder, frames
        ("u238_full", (92, 146, 128, 64), batch_full, 3.15576e19,
         make_sharded_frame_fn, lambda c: make_frame_fn(c, SUBSTEPS, batched=True), 2),
        ("c14_decay_only", (6, 8, 8, 8), batch_decay, 0.1 * 5730 * 31557600.0,
         make_sharded_decay_fn, lambda c: make_decay_frame_fn(c, SUBSTEPS), 3),
    )
    for label, (z, n, pad, log), batch, ts, sharded, single, frames in cases:
        cfg = SimConfig.for_isotope(z, n, pad_to=pad, max_chain_log=log)
        fn4 = sharded(cfg, SUBSTEPS, mesh)
        fn1 = single(cfg)
        s4 = shard_ensemble(ensemble_init(cfg, batch, seed=3), mesh)
        s1 = jax.device_put(ensemble_init(cfg, batch, seed=3), one)
        for _ in range(frames):
            s4, m4 = fn4(s4, ts, FRAME_DT)
        t0 = time.perf_counter()
        s4, m4 = fence(fn4(s4, ts, FRAME_DT))
        t4 = time.perf_counter() - t0
        for _ in range(frames):
            s1, m1 = fn1(s1, ts, FRAME_DT)
        t0 = time.perf_counter()
        s1, m1 = fence(fn1(s1, ts, FRAME_DT))
        t1 = time.perf_counter() - t0
        devices = {sh.device for sh in s4.z.addressable_shards}
        check(len(devices) == 4, f"{label}: shards on {len(devices)} devices")
        for f in ("z", "n", "decay_counts"):
            check(np.array_equal(np.asarray(getattr(s4, f)),
                                 np.asarray(getattr(s1, f))), f"{label}: {f} differs")
        surv4, surv1 = int(m4["survivors"]), int(
            np.sum((np.asarray(s1.z) == z) & (np.asarray(s1.n) == n))
        )
        check(surv4 == surv1, f"{label}: survivors {surv4} vs {surv1}")
        check(surv4 < batch, f"{label}: no decays fired")
        dpos = float(np.abs(np.asarray(s4.pos) - np.asarray(s1.pos)).max())
        check(dpos <= 1e-4, f"{label}: positions differ by {dpos}")
        rate = SUBSTEPS * batch
        out[label] = {
            "batch": batch, "survivors": surv4, "max_abs_dpos": dpos,
            "four_card_nucleus_substeps_per_s": rate / t4,
            "one_card_nucleus_substeps_per_s": rate / t1,
        }
        del s4, s1
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded ensemble phase")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1

    # The card or nothing: no fallback to the CPU.
    jax.config.update("jax_platforms", "cuda")
    sys.path.insert(0, ROOT)
    from pyqmd_tpu.utils.compile_cache import enable_compile_cache
    from pyqmd_tpu.utils.device import card_info, device_fields, require_gpu

    try:
        devices = require_gpu(count)
    except RuntimeError as e:
        sys.exit(f"chip_smoke: {e}")
    card = card_info()
    print(f"{card['card']}, {card['power_limit']}", flush=True)
    print(devices, flush=True)
    enable_compile_cache()
    report = Report(card)
    if args.four:
        report.run("four_cards", phase_four)
    else:
        ctx = {}
        report.run("session", phase_session)
        report.run("ensemble", phase_ensemble, ctx)
        report.run("forces", phase_forces, ctx)
        report.run("statistics", phase_statistics)
        report.run("render", phase_render)
    if report.failed:
        print(f"chip_smoke: failed phases: {report.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device_fields(devices)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
