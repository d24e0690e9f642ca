"""Sharded C-14 survival statistics on a device mesh.

Demonstrates the multi-device workflow end to end: on a machine with
several GPUs the mesh spans them; ``--platform cpu`` runs the identical
code on 8 virtual CPU devices anywhere. The same code scales across hosts
by calling ``initialize_multihost()`` first (the ``data`` axis then lays
across the hosts).

  * ``ensemble_init`` (pool placement) -> ``shard_ensemble`` over a 1-D
    ``data`` mesh,
  * ``make_sharded_run_fn``: 5 whole frames fused per sharded dispatch
    (4 dispatches total), decay counters and survivor counts psum'd,
  * half-life recovered from the psum'd survivor count.

Run: python examples/sharded_survival.py [--platform cpu]
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument(
    "--platform", choices=("cpu", "cuda"), default=None,
    help="force the JAX platform BEFORE any op (cpu = the 8-virtual-device "
    "demo mesh; default: whatever devices the machine has)",
)
parser.add_argument(
    "--cpu", action="store_const", const="cpu", dest="platform",
    help="shorthand for --platform cpu (matches the other examples)",
)
parser.add_argument(
    "--per-device", type=int, default=1024,
    help="nuclei per device (the smoke test uses a small value)",
)
args = parser.parse_args()

import jax

if args.platform:
    # Must happen before any jax op — a platform override after the
    # backend initializes is silently ignored (CLAUDE.md environment rules).
    jax.config.update("jax_platforms", args.platform)

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.init import ensemble_init
from pyqmd_tpu.parallel import (
    initialize_multihost,
    make_mesh,
    make_sharded_run_fn,
    shard_ensemble,
)

HL = 5730 * 31557600.0  # C-14 (decay_chains.py:37)


def main():
    initialize_multihost()  # no-op on one host; distributed init across hosts
    mesh = make_mesh()  # 1-D 'data' axis over every device
    n_dev = mesh.devices.size

    cfg = SimConfig.for_isotope(6, 8, pad_to=8)
    batch = args.per_device * n_dev
    states = shard_ensemble(ensemble_init(cfg, batch, seed=0), mesh)
    print(f"{batch} C-14 nuclei over {n_dev} devices ({jax.default_backend()})")

    # 2 tabulated half-lives of sim time: 4 sharded dispatches, each fusing
    # 5 frames x 10 substeps in one device program.
    frames_per_dispatch, dispatches, substeps = 5, 4, 10
    sim_seconds = 2.0 * HL
    frame_dt = 1.0
    time_scale = sim_seconds / (frames_per_dispatch * dispatches * frame_dt)
    run = make_sharded_run_fn(cfg, substeps, frames_per_dispatch, mesh)
    for _ in range(dispatches):
        states, metrics = run(states, time_scale, frame_dt)

    surv = int(metrics["survivors"]) / batch
    if surv >= 1.0:
        # Possible at tiny --per-device counts (P(all survive 2 T1/2) =
        # 0.25^B): -log(1.0) = -0.0 would divide by zero.
        raise SystemExit(
            f"no decays in {batch} members over 2 half-lives — "
            "raise --per-device for a measurable fit"
        )
    fit_hl = math.log(2) * sim_seconds / -math.log(max(surv, 1e-9))
    err = abs(fit_hl - HL) / HL
    print(f"survival after 2 T1/2: {surv:.4f} (expect 0.25)")
    print(f"fitted half-life: {fit_hl / 31557600.0:.0f} yr "
          f"(tabulated 5730; rel. error {err:.2%})")
    # 5-sigma band, scaled to the ensemble size: sigma_rel of the T-fit at
    # S = 0.25 over 2 half-lives is sqrt(S(1-S)/B)/(S|ln S|) ~ 1.25/sqrt(B).
    tol = max(0.05, 6.25 / math.sqrt(batch))
    assert err < tol, f"statistical fit out of tolerance ({err:.2%} > {tol:.2%})"


if __name__ == "__main__":
    main()
