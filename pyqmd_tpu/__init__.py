"""pyqmd_tpu — an accelerator-native nuclear structure and radioactive decay
engine, run on NVIDIA GPUs.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of OtsoBear/PyQMD
(reference at /root/reference): an O(N^2) pairwise nucleon force model
(strong force, Coulomb, Pauli exclusion, hard core, center-of-mass
containment), tabulated + predicted decay chains (alpha/beta-/beta+/gamma/
n/p/fission) driven by half-life statistics, ejecta animation, a headless
framebuffer renderer, and an interactive terminal app.

Design (accelerator-first, not a translation):
  * one immutable SoA ``NucleusState`` pytree with fixed max-A padding and
    alive masks (vs. the reference's Python ``Particle`` object lists),
  * one pure jit-compiled ``step`` with substeps inside ``lax.scan`` (vs.
    the reference's per-substep host<->device round trips,
    nuclear_forces.py:202-234),
  * counter-based ``jax.random`` decay sampling inside the step (vs.
    Python ``random.random()``, particles.py:147),
  * ensembles as a vmapped batch dimension sharded over a device mesh
    with ``shard_map`` and ``psum``-aggregated decay statistics,
  * a fused Pallas (Triton route) force+integrate kernel as the
    native-code equivalent of the reference's embedded OpenCL kernel
    (nuclear_forces.py:57-173).
"""

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.state import NucleusState, empty_state
from pyqmd_tpu.core.init import ensemble_init, init_state, mixed_ensemble_init
from pyqmd_tpu.core.step import (
    decay_ensemble_step,
    ensemble_step,
    make_decay_frame_fn,
    make_frame_fn,
    simulate_frame,
)
from pyqmd_tpu.sim import Simulation

__version__ = "0.6.0"

__all__ = [
    "SimConfig",
    "NucleusState",
    "Simulation",
    "empty_state",
    "init_state",
    "ensemble_init",
    "mixed_ensemble_init",
    "simulate_frame",
    "ensemble_step",
    "decay_ensemble_step",
    "make_frame_fn",
    "make_decay_frame_fn",
    "__version__",
]
