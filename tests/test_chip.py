"""The fused force kernel compiled for the GPU, at real widths.

Marked ``chip``: run on a machine with an NVIDIA GPU by

    JAX_PLATFORMS=cuda python -m pytest tests/ -m chip

Elsewhere the ``gpu`` fixture skips them (the kernel has no CPU lowering;
tests/test_kernel.py covers its arithmetic in interpret mode).
"""

import jax
import numpy as np
import pytest

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.forces import force_step
from pyqmd_tpu.core.init import ensemble_init
from pyqmd_tpu.core.step import make_frame_fn
from pyqmd_tpu.kernels.forces_pallas import force_step_pallas

pytestmark = pytest.mark.chip


@pytest.mark.parametrize(
    "z,n,pad_to,integrator",
    [(92, 146, 128, "euler"), (2, 2, 8, "euler"), (92, 146, 128, "leapfrog")],
)
def test_compiled_kernel_matches_jnp(gpu, z, n, pad_to, integrator):
    """Compiled kernel against XLA's jnp step on a settled 1,024-member
    batch: within 1e-5, relative where |x| > 1 (float32 spacing at the
    ~400 positions is 3.05e-5)."""
    cfg = SimConfig.for_isotope(z, n, pad_to=pad_to, integrator=integrator)
    states = ensemble_init(cfg, 1024, seed=0)
    frame = make_frame_fn(cfg, 4, batched=True)
    for _ in range(3):
        states, _ = frame(states, 1.0, 1 / 60)
    args = (states.pos, states.vel, states.ptype, states.alive)
    dt = cfg.effective_dt()
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda *a: force_step(*a, dt, cfg))(*args)
    out = jax.jit(lambda *a: force_step_pallas(*a, dt, cfg))(*args)
    for a, r in zip(out, ref):
        a, r = np.asarray(a), np.asarray(r)
        assert (np.abs(a - r) / np.maximum(1.0, np.abs(r))).max() <= 1e-5


def test_kernel_frame_runs(gpu):
    """A full-physics ensemble frame on the kernel backend: finite state,
    conserved alive count."""
    cfg = SimConfig.for_isotope(92, 146, pad_to=128, force_backend="pallas")
    states = ensemble_init(cfg, 2048, seed=1)
    alive0 = int(states.alive.sum())
    frame = make_frame_fn(cfg, 20, batched=True)
    for _ in range(2):
        states, metrics = frame(states, 1.0, 1 / 60)
    assert not bool(np.asarray(metrics["nan"]).any())
    assert int(states.alive.sum()) == alive0
