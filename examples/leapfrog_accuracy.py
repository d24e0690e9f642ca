"""Integrator quality demo: velocity-Verlet vs the reference's Euler.

The reference integrates with damped semi-implicit Euler
(/root/reference/nuclear_forces.py:156-171) — first-order accurate. The
rebuild adds ``SimConfig.integrator="leapfrog"`` (velocity-Verlet,
second order) on every backend: the jnp oracle, the fused GPU kernel (as
two sweeps per step), and the ppermute ring.

This script shows two textbook properties on an undamped three-nucleon
configuration:

1. **Convergence order**: halving dt cuts Euler's error ~2x but
   leapfrog's ~4x (global error O(dt) vs O(dt^2)).
2. **Time reversibility**: running N steps with +dt then N with -dt
   returns leapfrog to the initial state to float precision; Euler
   drifts.

Run: ``python examples/leapfrog_accuracy.py`` (CPU, a few seconds).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyqmd_tpu import SimConfig  # noqa: E402
from pyqmd_tpu.core.forces import force_step  # noqa: E402
from pyqmd_tpu.state import NEUTRON, PROTON  # noqa: E402

BASE = dict(z=2, n=2, max_particles=8, damping=1.0)  # undamped dynamics

pos0 = np.zeros((8, 2), np.float32)
pos0[0] = (0.0, 0.0)
pos0[1] = (7.0, 0.0)
pos0[2] = (3.5, 6.0)  # smooth attractive regime (no hard-core clamp)
vel0 = np.zeros((8, 2), np.float32)
ptype = jnp.asarray([PROTON, NEUTRON, NEUTRON] + [0] * 5, jnp.int32)
alive = jnp.asarray([True] * 3 + [False] * 5)


def rollout(cfg, dt, steps):
    p, v = jnp.asarray(pos0), jnp.asarray(vel0)
    step = jax.jit(lambda p, v, dt: force_step(p, v, ptype, alive, dt, cfg))
    for _ in range(steps):
        p, v = step(p, v, dt)
    return p, v


def main():
    cfg_e = SimConfig(**BASE, integrator="euler")
    cfg_l = SimConfig(**BASE, integrator="leapfrog")
    t_end, dts = 0.2, [1 / 60, 1 / 120, 1 / 240]

    truth, _ = rollout(cfg_l, t_end / 3840, 3840)
    print("convergence (max position error vs fine-step truth):")
    print(f"  {'dt':>10} {'euler':>12} {'leapfrog':>12}")
    for dt in dts:
        n = round(t_end / dt)
        err_e = float(jnp.abs(rollout(cfg_e, dt, n)[0] - truth).max())
        err_l = float(jnp.abs(rollout(cfg_l, dt, n)[0] - truth).max())
        print(f"  {dt:10.5f} {err_e:12.3e} {err_l:12.3e}")

    print("\ntime reversibility (|x_roundtrip - x0| after 60 steps out + back):")
    for name, cfg in (("euler", cfg_e), ("leapfrog", cfg_l)):
        p, v = rollout(cfg, 1 / 120, 60)
        step = jax.jit(lambda p, v: force_step(p, v, ptype, alive, -1 / 120, cfg))
        for _ in range(60):
            p, v = step(p, v)
        drift = float(jnp.abs(p - jnp.asarray(pos0)).max())
        print(f"  {name:9s} {drift:.3e}")


if __name__ == "__main__":
    main()
