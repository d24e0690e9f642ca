"""Host driver + CLI + checkpoint + formatter tests.

Covers the interactive capability surface of the reference's event system
(/root/reference/nuclear_sim.py:381-521) as exposed by Simulation and the
CLI, plus the aux subsystems: checkpoint/resume and unit formatting.
"""

import json
import math

import numpy as np
import pytest

from pyqmd_tpu.cli import main as cli_main
from pyqmd_tpu.sim import ISOTOPE_KEYMAP, TIME_SCALE_PRESETS, Simulation
from pyqmd_tpu.utils.checkpoint import load_checkpoint, save_checkpoint
from pyqmd_tpu.utils.format import (
    format_half_life,
    format_time_scale,
    format_time_value,
    format_time_value_with_unit,
    parse_time_scale,
)


# --- formatters (nuclear_sim.py:561-587, rendering.py:394-478) --------------


def test_format_time_value_with_unit():
    assert format_time_value_with_unit(0) == "0 s"
    assert format_time_value_with_unit(2.5e-16) == "250.00 as"
    assert format_time_value_with_unit(2.5e-13) == "250.00 fs"
    assert format_time_value_with_unit(3.53 * 86400) == "3.53 days"
    assert format_time_value_with_unit(164.3e-6) == "164.30 μs"
    assert format_time_value_with_unit(5730 * 31557600.0) == "5730.00 years"


def test_format_time_scale():
    assert format_time_scale(1.0) == "x1.0 (real-time)"
    assert format_time_scale(3600.0) == "1.0 hours/s"
    assert format_time_scale(31557600000000000.0) == "1.0 billion years/s"
    assert format_time_scale(1e-7) == "100 ns/s"


def test_format_time_value_units():
    assert format_time_value(30)[1] == "seconds"
    assert format_time_value(90)[1] == "minutes"
    assert format_time_value(1e10)[1] == "years"


def test_format_half_life_buckets():
    assert format_half_life(float("inf")) == ("Stable", "stable")
    label, sev = format_half_life(5730 * 31557600.0)
    assert sev == "long" and "millennia" in label
    assert format_half_life(10.0)[1] == "short"


def test_parse_time_scale():
    assert parse_time_scale("1e9yr") == pytest.approx(1e9 * 31557600.0)
    assert parse_time_scale("5day") == pytest.approx(5 * 86400.0)
    assert parse_time_scale("2h") == pytest.approx(7200.0)
    assert parse_time_scale("3600") == 3600.0
    assert parse_time_scale("min") == 60.0


# --- Simulation driver -------------------------------------------------------


def test_simulation_frame_and_controls():
    sim = Simulation(z=6, n=8, seed=0, pad_to=8)
    sim.frame()
    assert sim.substeps_used == 4  # 1/60 at ts=1 with dt=1/240
    sim.set_preset("billion")
    assert sim.time_scale == TIME_SCALE_PRESETS["billion"]
    sim.frame()
    assert sim.substeps_used == 20  # clamped at max
    sim.scale_time(10.0)
    sim.scale_time(1e40)  # clamps at max
    assert sim.time_scale == 1e30
    with pytest.raises(KeyError):
        sim.set_preset("warp")


def test_simulation_force_decay_logs():
    sim = Simulation(z=92, n=146, seed=0, pad_to=128)
    sim.force_decay()
    assert len(sim.decay_log) == 1
    assert "U-238 → Th-234 (α)" in sim.decay_log[0]
    assert sim.isotope == "Th-234"
    entries = sim.chain_entries()
    assert entries[-1]["parent"] == (92, 146)
    assert entries[-1]["child"] == (90, 144)


def test_simulation_isotope_keymap():
    sim = Simulation(z=92, n=146, seed=0, pad_to=8)
    sim.set_isotope_key(3)
    assert sim.isotope == "C-14"
    assert ISOTOPE_KEYMAP[9] == (92, 146)


def test_simulation_camera_zoom():
    sim = Simulation(z=2, n=2, pad_to=8)
    sim.zoom_by(1e9)
    assert sim.target_zoom == 100.0  # clamped (nuclear_sim.py:75)
    sim.pan(1.0, -1.0)
    assert sim.camera_target[0] > sim.cfg.origin_x
    z0 = sim.zoom
    sim._lerp_camera()
    assert sim.zoom > z0  # lerping toward target


def test_simulation_status_fields():
    sim = Simulation(z=6, n=8, pad_to=8)
    s = sim.status()
    for k in ("isotope", "z", "n", "half_life", "alive", "decay_counts",
              "time_passed", "time_scale", "backend", "platform", "fps",
              "substeps_per_sec", "rms_radius", "kinetic_energy"):
        assert k in s
    assert s["alive"] == 14
    # C-14 matter radius: same scale as the initializer's R = 1.2*A^(1/3)
    # shells (in sim units; finite and physically plausible).
    assert 0.5 < s["rms_radius"] < 50.0
    assert s["kinetic_energy"] >= 0.0


def test_simulation_throughput_observability():
    """The driver tracks fps/substeps-per-sec over retired frames (the
    reference's 30-frame FPS deque, nuclear_sim.py:60, 119-121)."""
    sim = Simulation(z=2, n=2, pad_to=8)
    for _ in range(8):  # enough to fill the 4-deep pipeline and retire
        sim.frame()
    s = sim.status()
    assert s["fps"] > 0
    assert s["substeps_per_sec"] > 0
    # substeps/s is consistent with fps x substeps-per-frame.
    assert s["substeps_per_sec"] == pytest.approx(
        s["fps"] * sim.substeps_used, rel=0.5
    )


def test_substeps_exact_without_auto_adjust():
    """With auto-adjust off, substep counts must match the reference's exact
    integer (nuclear_sim.py:153) — no ladder snapping (ADVICE r2)."""
    sim = Simulation(z=2, n=2, pad_to=8)
    sim.physics_dt = 1.0 / 240.0
    # frame_dt * ts / dt = 7 exactly: the ladder would snap this to 6.
    num, _ = sim._schedule(7.0 / 240.0)
    assert num == 7
    sim.auto_adjust_substeps = True
    sim.time_scale = 1.0  # auto path with ts == 1 keeps physics_dt
    num, _ = sim._schedule(7.0 / 240.0)
    assert num == 6  # ladder applies only in auto-adjust mode


def test_run_zero_frames_returns_last_metrics():
    sim = Simulation(z=2, n=2, pad_to=8)
    assert sim.run(0) is None  # no frames yet -> last_metrics is None
    m = sim.frame()
    assert sim.run(0) is m


def test_simulation_ensemble_mode():
    sim = Simulation(z=6, n=8, pad_to=8, ensemble=8)
    m = sim.frame()
    assert sim.batched
    assert int(m["total_alive"]) == 8 * 14
    s = sim.status()
    assert s["ensemble"] == 8
    with pytest.raises(RuntimeError):
        sim.force_decay()


# --- checkpoint (SURVEY §5) ---------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    sim = Simulation(z=92, n=146, seed=1, pad_to=128)
    sim.frame()
    sim.force_decay()
    path = str(tmp_path / "ck.npz")
    sim.save(path)
    state, cfg = load_checkpoint(path)
    assert cfg == sim.cfg
    np.testing.assert_array_equal(np.asarray(state.pos), np.asarray(sim.state.pos))
    assert int(state.chain_cursor) == int(sim.state.chain_cursor)

    resumed = Simulation.load(path)
    assert resumed.isotope == sim.isotope
    resumed.frame()  # resumable: stepping works
    assert np.isfinite(np.asarray(resumed.state.pos)).all()


def test_checkpoint_rejects_garbage(tmp_path):
    p = tmp_path / "bad.npz"
    np.savez(p, foo=np.zeros(3))
    with pytest.raises(Exception):
        load_checkpoint(str(p))


# --- CLI ----------------------------------------------------------------------


def test_cli_batch_run(tmp_path, capsys):
    png = tmp_path / "out.png"
    ck = tmp_path / "out.npz"
    rc = cli_main([
        "--isotope", "C-14", "--frames", "3", "--time-scale", "2.0",
        "--render", str(png), "--save", str(ck), "--status-json", "-q",
        "--width", "120", "--height", "90",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "isotope:    C-14" in out
    status = json.loads(out.strip().splitlines()[-1])
    assert status["z"] == 6 and status["alive"] == 14
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert ck.exists()


def test_cli_resume(tmp_path, capsys):
    ck = tmp_path / "r.npz"
    cli_main(["--isotope", "He-4", "--frames", "2", "--save", str(ck), "-q"])
    rc = cli_main(["--load", str(ck), "--frames", "2", "-q"])
    assert rc == 0
    assert "He-4" in capsys.readouterr().out


def test_cli_interactive(tmp_path, capsys, monkeypatch):
    import io

    commands = "status\ndecay\nt 1e6yr\nstep 2\nchain\nbogus\nquit\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(commands))
    rc = cli_main(["--isotope", "U-238", "-i", "-q"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "U-238 → Th-234" in out
    assert "unknown command 'bogus'" in out


def test_cli_interactive_all_commands(tmp_path, capsys, monkeypatch):
    """Drive every REPL command once (the full keyboard surface)."""
    import io

    png = tmp_path / "v.png"
    ck = tmp_path / "v.npz"
    commands = "\n".join([
        "help",
        "status",
        "step 2",
        "run 2",
        "decay",
        "faster", "slower", "ff", "rew",
        "t 1e6yr",
        "preset hour",
        "iso C-14",
        "iso 9",
        "zoom in", "zoom out", "zoom 12",
        "pan 1 -1",
        "auto", "auto",
        "dt 0.005",
        "accuracy 0.8",
        "substeps 10",
        "chain",
        "scroll 2", "scroll -1", "scroll reset",
        "iscroll 3", "iscroll reset",
        "size 400 300",
        "show ascii",
        "show",
        "watch 0.3",
        f"render {png}",
        f"save {ck}",
        f"load {ck}",
        "quit",
    ]) + "\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(commands))
    rc = cli_main(["--isotope", "U-238", "-i", "-q", "--backend", "jnp"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "error:" not in out
    assert "auto-adjust substeps: ON" in out and "auto-adjust substeps: OFF" in out
    assert "physics dt: 0.005000s" in out
    assert "\x1b[38;2;" in out  # truecolor 'show'
    assert png.exists() and ck.exists()
    assert "loaded:" in out


def test_cli_interactive_ensemble_mode_survives_bad_commands(capsys, monkeypatch):
    """Single-nucleus-only commands (decay, chain) and out-of-range values
    (accuracy 2) must print '  error: ...' in the REPL, not crash it."""
    import io

    commands = "decay\nchain\naccuracy 2\nstatus\nquit\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(commands))
    rc = cli_main(["--isotope", "C-14", "--ensemble", "4", "-i", "-q",
                   "--backend", "jnp"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("error:") == 3  # decay, chain, accuracy all rejected
    assert "C-14 x4" in out  # status still works afterwards


def test_status_packed_readback_matches_state_fields():
    """status() fetches its device scalars in ONE packed readback
    (bitcast int words + f32 floats); values must match per-field reads."""
    import numpy as np

    from pyqmd_tpu.sim import Simulation

    sim = Simulation(z=6, n=8, pad_to=16)
    sim.set_time_scale(3.15576e10)
    for _ in range(3):
        sim.frame()
    s = sim.status()
    st = sim.state
    assert s["z"] == int(st.z) and s["n"] == int(st.n)
    assert s["isotope"].split("-")[0] in ("C", "N")
    assert s["alive"] == int(st.alive_count())
    assert s["ejecta"] == int(np.asarray(st.ej_alive).sum())
    assert s["decay_counts"] == np.asarray(st.decay_counts).tolist()
    assert s["half_life"] == float(np.float32(st.half_life))
    assert s["time_passed"] == float(np.float32(st.time_passed))
    np.testing.assert_allclose(s["rms_radius"], float(st.rms_radius()), rtol=1e-5)
    np.testing.assert_allclose(
        s["kinetic_energy"], float(st.kinetic_energy()), rtol=1e-5
    )


def test_reset_clears_decay_log():
    """Switching isotopes is a full session reset (nuclear_sim.py:92-116):
    the previous nucleus's decay-log lines must not survive into the new
    one's log."""
    from pyqmd_tpu.sim import Simulation

    sim = Simulation(z=6, n=8, pad_to=16)
    sim.force_decay()
    assert len(sim.decay_log) == 1
    sim.reset(z=92, n=146)
    assert sim.decay_log == []


def test_checkpoint_orbax_roundtrip(tmp_path):
    from pyqmd_tpu.config import SimConfig
    from pyqmd_tpu.core.init import init_state
    from pyqmd_tpu.utils.checkpoint import (
        load_checkpoint_orbax,
        save_checkpoint_orbax,
    )

    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    st = init_state(cfg, seed=0)
    path = str(tmp_path / "ock")
    save_checkpoint_orbax(path, st, cfg)
    st2, cfg2 = load_checkpoint_orbax(path)
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(st.pos), np.asarray(st2.pos))
    np.testing.assert_array_equal(np.asarray(st.rng), np.asarray(st2.rng))


def test_chain_drain_cadence_prevents_ring_loss():
    """The driver drains the decay log before the potential backlog could
    wrap the chain ring (at most num_steps entries per frame), so no log
    line is ever silently lost (code-review r3 finding)."""
    sim = Simulation(z=2, n=2, pad_to=8)  # stable: tests the *potential* bound
    cap = sim.cfg.max_chain_log
    drains = []
    orig = sim._drain_chain_log

    def spy():
        drains.append(sim.frame_count)
        orig()

    sim._drain_chain_log = spy
    sim.set_preset("billion")  # 20 substeps per frame
    for _ in range(30):
        sim.frame()
    assert drains, "drain never ran"
    # The pre-dispatch check guarantees undrained + this frame's substeps
    # stays under the ring capacity at every dispatch.
    worst_gap_frames = cap // sim.max_substeps + 1
    gaps = [b - a for a, b in zip([0] + drains, drains)]
    assert all(g <= worst_gap_frames for g in gaps), (gaps, worst_gap_frames)
    # Auto-adjust frames can run up to 200 substeps; the pre-dispatch check
    # uses the ACTUAL count, so the guarantee holds there too.
    sim.auto_adjust_substeps = True
    drains.clear()
    before = sim.frame_count
    for _ in range(6):
        sim.frame()
    assert sim.substeps_used > sim.max_substeps  # auto mode exceeded 20
    assert drains and drains[0] - before <= cap // sim.substeps_used + 1


def test_chain_scroll_clamps_on_render():
    """Overshooting 'scroll' clamps the STORED value on render so scrolling
    back responds immediately (rendering.py:289-292 analog)."""
    sim = Simulation(z=92, n=146, seed=0, pad_to=128)
    for _ in range(3):
        sim.force_decay()
    sim.chain_scroll = 10**6
    sim.render(400, 300)
    assert sim.chain_scroll <= 3


def test_pool_and_exact_member_identity_consistent():
    """Pool-init members draw identity (half-life, rng, chain seed) from
    the same key schedule as exact init (shared _member_identity)."""
    import jax

    from pyqmd_tpu.config import SimConfig
    from pyqmd_tpu.core.init import _init_from_key, _member_identity

    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    key = jax.numpy.asarray(np.asarray([7, 9], np.uint32))
    key = jax.random.wrap_key_data(key)
    a = _init_from_key(cfg, key)
    b = _member_identity(cfg, key)
    np.testing.assert_array_equal(np.asarray(a.rng), np.asarray(b.rng))
    assert float(a.half_life) == float(b.half_life)
    np.testing.assert_array_equal(np.asarray(a.ptype), np.asarray(b.ptype))
    assert int(a.chain_cursor) == int(b.chain_cursor) == 1


def test_cli_config_overrides(capsys):
    """--set FIELD=VALUE: the configurable-physics surface (ROADMAP)."""
    from pyqmd_tpu.cli import parse_overrides

    ov = parse_overrides([
        "strong_strength=120", "integrator=leapfrog", "max_substeps=10",
    ])
    assert ov == {
        "strong_strength": 120.0,
        "integrator": "leapfrog", "max_substeps": 10,
    }
    with pytest.raises(ValueError):
        parse_overrides(["bogus_field=1"])
    with pytest.raises(ValueError):
        parse_overrides(["no_equals"])

    rc = cli_main([
        "--isotope", "He-4", "--frames", "2", "-q", "--status-json",
        "--set", "strong_strength=100", "--set", "damping=0.9",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["alive"] == 4


def test_overrides_survive_isotope_switch():
    sim = Simulation(z=2, n=2, pad_to=8, overrides={"strong_strength": 99.0})
    assert sim.cfg.strong_strength == 99.0
    sim.reset(6, 8)
    assert sim.cfg.strong_strength == 99.0  # re-applied on switch
    assert sim.cfg.z == 6
    sim.frame()  # physics runs with the overridden constant
    assert np.isfinite(np.asarray(sim.state.pos)).all()


def test_cli_set_with_load_and_error_paths(tmp_path, capsys):
    ck = tmp_path / "s.npz"
    cli_main(["--isotope", "He-4", "--frames", "1", "--save", str(ck), "-q"])
    capsys.readouterr()
    # Overrides apply on resume.
    rc = cli_main([
        "--load", str(ck), "--frames", "1", "-q", "--status-json",
        "--set", "strong_strength=120",
    ])
    assert rc == 0
    # Shape-changing overrides on --load are rejected cleanly.
    with pytest.raises(SystemExit):
        cli_main(["--load", str(ck), "--set", "max_particles=512", "-q"])
    # Malformed --set exits with a usage error, not a traceback.
    with pytest.raises(SystemExit):
        cli_main(["--set", "bogus_field=1", "-q"])
    with pytest.raises(SystemExit):
        cli_main(["--set", "no_equals", "-q"])


def test_cli_populations_and_theory(tmp_path, capsys):
    """--populations writes the measured per-isotope CSV; --theory writes
    the Bateman expectation on the same time grid (fractions sum to 1)."""
    pops = tmp_path / "pops.csv"
    theory = tmp_path / "theory.csv"
    rc = cli_main([
        "--isotope", "Pb-214", "--ensemble", "256", "--frames", "6",
        "--half-lives", "2", "--populations", str(pops),
        "--theory", str(theory), "-q",
    ])
    assert rc == 0
    lines = pops.read_text().strip().splitlines()
    header = lines[0].split(",")
    assert header[0] == "time_s" and "82:132" in header
    assert len(lines) == 8  # header + 7 time points
    # Measured counts at t=0: all members are the parent.
    row0 = dict(zip(header, lines[1].split(",")))
    assert row0["82:132"] == "256"
    tl = theory.read_text().strip().splitlines()
    th = tl[0].split(",")
    vals = [float(x) for x in tl[-1].split(",")[1:]]
    assert abs(sum(vals) - 1.0) < 1e-6  # fractions conserve
    assert len(tl) == 8

    # --theory standalone (no simulation) on a stable isotope errors.
    import pytest as _pytest

    with _pytest.raises(SystemExit):
        cli_main(["--isotope", "He-4", "--theory", str(theory)])


def test_python_dash_m_package_entry():
    """``python -m pyqmd_tpu`` is the CLI (the reference's entry point is
    ``python nuclear_sim.py``, nuclear_sim.py:615-617)."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, "-m", "pyqmd_tpu", "--help"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0
    assert "--serve" in r.stdout and "--isotope" in r.stdout
