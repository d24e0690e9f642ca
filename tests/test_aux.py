"""Aux subsystem tests (SURVEY §5): NaN guard, kernel faults, profiling,
the compile-cache rule and the GPU-only measurement entry points."""

import logging
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import pytest

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.init import init_state
from pyqmd_tpu.core.step import simulate_frame
from pyqmd_tpu.sim import Simulation
from pyqmd_tpu.utils.profiling import StepTimer


def test_nan_guard_metric():
    cfg = SimConfig.for_isotope(2, 2, pad_to=8)
    st = init_state(cfg, seed=0)
    _, m = simulate_frame(st, cfg, 1.0, 1 / 60.0, 2)
    assert not bool(m["nan"])
    # Poison the state: the guard must fire.
    bad = st.replace(pos=st.pos.at[0, 0].set(jnp.nan))
    _, m = simulate_frame(bad, cfg, 1.0, 1 / 60.0, 2)
    assert bool(m["nan"])


def test_nan_guard_logs(caplog):
    sim = Simulation(z=2, n=2, pad_to=8)
    sim.nan_check_interval = 1  # default cadence is every 30 frames
    sim.state = sim.state.replace(pos=sim.state.pos.at[0, 0].set(jnp.inf))
    with caplog.at_level(logging.ERROR, logger="pyqmd_tpu"):
        sim.frame()
    assert any("non-finite" in r.message for r in caplog.records)


def test_nan_guard_default_cadence(caplog):
    """The guard reads back only every nan_check_interval frames (the
    per-frame device sync was the interactive-path bottleneck, VERDICT r2)."""
    sim = Simulation(z=2, n=2, pad_to=8)
    sim.state = sim.state.replace(pos=sim.state.pos.at[0, 0].set(jnp.inf))
    with caplog.at_level(logging.ERROR, logger="pyqmd_tpu"):
        for _ in range(sim.nan_check_interval - 1):
            sim.frame()
        assert not any("non-finite" in r.message for r in caplog.records)
        sim.frame()  # the Nth frame triggers the readback
    assert any("non-finite" in r.message for r in caplog.records)


def test_kernel_fault_raises():
    """A kernel that cannot run raises; there is no silent fallback to
    another backend (the compiled GPU kernel has no CPU lowering)."""
    sim = Simulation(z=2, n=2, pad_to=8, force_backend="pallas")
    assert sim.cfg.force_backend == "pallas"
    with pytest.raises(ValueError, match="interpret"):
        sim.frame()
    assert sim.cfg.force_backend == sim.force_backend == "pallas"


def test_step_timer():
    t = StepTimer(window=4)
    t.start()
    for _ in range(3):
        t.lap(jnp.zeros(4), steps=10)
    assert t.steps_per_sec > 0


def test_render_ascii():
    sim = Simulation(z=6, n=8, pad_to=8)
    art = sim.render_ascii(width=48, height=20)
    lines = art.splitlines()
    assert len(lines) == 20 and all(len(l) == 48 for l in lines)
    assert "o" in art and "." in art  # protons and neutrons visible


def test_version_consistent_with_pyproject():
    """__version__ and pyproject.toml must agree (r4 shipped them split:
    pyproject 0.5.0 vs __version__ 0.4.0)."""
    import tomllib
    import pyqmd_tpu

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        pyproject = tomllib.load(f)
    assert pyqmd_tpu.__version__ == pyproject["project"]["version"]


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_requires_gpu():
    """bench.py measures nothing without an NVIDIA GPU: on the CPU its
    main() raises before any timing."""
    added = ROOT not in sys.path
    if added:
        sys.path.insert(0, ROOT)
    try:
        import bench

        with pytest.raises(RuntimeError, match="GPU"):
            bench.main()
    finally:
        if added:
            sys.path.remove(ROOT)


def _record_config_updates(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_compile_cache_dir_unset_uses_repo_dir(monkeypatch):
    from pyqmd_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config_updates(monkeypatch)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_compile_cache_dir_env_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, no code sets another directory
    (JAX reads the variable itself)."""
    from pyqmd_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _record_config_updates(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []


def _run_chip_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a GPU,
    both from the repo and from a directory holding only the script."""
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd in (ROOT, str(alone)):
        res = _run_chip_smoke(cwd)
        assert res.returncode != 0, res.stdout
        assert '"ok": true' not in res.stdout
