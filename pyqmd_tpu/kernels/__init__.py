"""Native GPU kernels (Pallas, Triton route)."""

from pyqmd_tpu.kernels.forces_pallas import force_step_pallas

__all__ = ["force_step_pallas"]
