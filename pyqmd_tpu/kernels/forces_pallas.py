"""Fused force + integrate kernel for NVIDIA GPUs (Pallas, Triton route).

The native-code counterpart of the reference's embedded OpenCL kernel
``update_forces_and_positions`` (/root/reference/nuclear_forces.py:57-173)
and a drop-in replacement for :func:`pyqmd_tpu.core.forces.force_step`
(the jnp oracle). The pair chain is the oracle's own
:func:`~pyqmd_tpu.core.forces.pair_net_force`, so both backends share one
statement of the physics.

Execution shape:

  * each program owns whole nuclei: one for a heavy nucleus (U-238 at a
    capacity of 256), a power-of-two group of small ones (He-4 at 8,
    C-14 at 16), so every program has a few thousand pair lanes of work;
  * the program loops over blocks of partners, keeping the
    (nuclei x rows x partners) tile in registers and only the per-row
    force sums across iterations — no pair array ever reaches device
    memory;
  * alive count and center of mass are reduced in-kernel, and the
    integrate step is fused, so a substep reads and writes the state once.

Leapfrog (velocity-Verlet) runs as two calls, kick-drift then kick: the
second force sweep needs every row's drifted position, which on the GPU
is a grid-wide dependency.

Equivalence with the jnp path is pinned by tests/test_kernel.py with the
kernel in interpret mode on the CPU, and at full width on the card by
chip_smoke.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.forces import pair_net_force
from pyqmd_tpu.state import PROTON

# Elements of one (nuclei x rows x partners) tile. Sets the partner block
# and the nuclei per program (see block_layout). Chosen by a sweep on an
# H100 (PERF.md): small tiles keep the pair chain's ~20 live values per
# element in registers.
TILE_ELEMS = 256
NUM_WARPS = 2


def block_layout(p: int, batch: int, tile_elems: int = TILE_ELEMS):
    """``(padded capacity, partner block, nuclei per program)`` for
    capacity ``p`` and ``batch`` nuclei.

    Triton blocks are powers of two, so the capacity pads up to one with
    dead slots. The partner block fills the tile for a single nucleus; the
    rest of the tile goes to more nuclei, but never more than the batch
    holds (a single nucleus is not padded to a group).
    """
    p2 = pl.next_power_of_2(p)
    block_j = max(1, min(p2, tile_elems // p2))
    group = max(1, tile_elems // (p2 * block_j))
    group = min(group, pl.next_power_of_2(batch))
    return p2, block_j, group


def _force_kernel(
    dt_ref,  # () f32
    x_ref, y_ref, vx_ref, vy_ref,  # (G, P) f32
    isp_ref, m_ref,  # (G, P) f32: proton indicator, alive mask
    ox_ref, oy_ref, ovx_ref, ovy_ref,  # outputs (G, P)
    *,
    cfg: SimConfig,
    block_j: int,
    kick: float,
    damp: bool,
    drift: bool,
):
    """One force sweep and the update
    ``v' = (v + F·kick·dt)·damping?``, ``x' = x + v'·dt`` (if ``drift``),
    applied to alive slots only."""
    dt = dt_ref[...]
    x = x_ref[...]
    y = y_ref[...]
    m = m_ref[...]
    isp = isp_ref[...]
    alive = m > 0

    def partner_block(jb, carry):
        fx, fy = carry
        cols = pl.ds(jb * block_j, block_j)
        xj = x_ref[:, cols]
        yj = y_ref[:, cols]
        mj = m_ref[:, cols]
        ispj = isp_ref[:, cols]
        # d[g, i, j] = pos_j - pos_i, as in core.forces.pair_forces_block.
        dx = xj[:, None, :] - x[:, :, None]
        dy = yj[:, None, :] - y[:, :, None]
        dist2 = dx * dx + dy * dy
        pair = (m[:, :, None] * mj[:, None, :] > 0) & (dist2 >= 0.01)
        dist = jnp.sqrt(jnp.maximum(dist2, 1e-12))
        is_pp = isp[:, :, None] * ispj[:, None, :] > 0
        is_same = isp[:, :, None] == ispj[:, None, :]
        net = pair_net_force(dist, dist2, is_pp, is_same, cfg)
        g = jnp.where(pair, net / dist, 0.0)
        return fx + jnp.sum(g * dx, axis=2), fy + jnp.sum(g * dy, axis=2)

    zeros = jnp.zeros(x.shape, jnp.float32)
    fx, fy = jax.lax.fori_loop(
        0, x.shape[1] // block_j, partner_block, (zeros, zeros)
    )

    # Center-of-mass containment spring (core.forces.com_force).
    safe = jnp.maximum(jnp.sum(m, axis=1), 1.0)[:, None]
    cdx = jnp.sum(x * m, axis=1)[:, None] / safe - x
    cdy = jnp.sum(y * m, axis=1)[:, None] / safe - y
    cdist = jnp.sqrt(cdx * cdx + cdy * cdy)
    radius = 1.2 * safe ** (1.0 / 3.0) * 2.0
    active = (cdist > radius * 1.5) & (cdist > 0.01)
    scale = jnp.where(
        active & alive,
        cfg.com_spring * (cdist - radius) / jnp.maximum(cdist, 1e-9),
        0.0,
    )
    fx = fx + cdx * scale
    fy = fy + cdy * scale

    vx = vx_ref[...]
    vy = vy_ref[...]
    nvx = vx + fx * (kick * dt)
    nvy = vy + fy * (kick * dt)
    if damp:
        nvx = nvx * cfg.damping
        nvy = nvy * cfg.damping
    ovx_ref[...] = jnp.where(alive, nvx, vx)
    ovy_ref[...] = jnp.where(alive, nvy, vy)
    if drift:
        ox_ref[...] = jnp.where(alive, x + nvx * dt, x)
        oy_ref[...] = jnp.where(alive, y + nvy * dt, y)
    else:
        ox_ref[...] = x
        oy_ref[...] = y


def _sweep(dt, x, y, vx, vy, isp, m, cfg, layout, stage, interpret):
    """One ``pallas_call`` over the padded (B', P') planes."""
    _, block_j, group = layout
    rows, p2 = x.shape
    kick, damp, drift = stage
    spec = pl.BlockSpec((group, p2), lambda i: (i, 0))
    kernel = functools.partial(
        _force_kernel, cfg=cfg, block_j=block_j, kick=kick, damp=damp,
        drift=drift,
    )
    return pl.pallas_call(
        kernel,
        grid=(rows // group,),
        in_specs=[pl.no_block_spec] + [spec] * 6,
        out_specs=[spec] * 4,
        out_shape=[jax.ShapeDtypeStruct((rows, p2), jnp.float32)] * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="force_integrate",
    )(dt, x, y, vx, vy, isp, m)


# (kick, damp, drift) per call: Euler is one sweep; leapfrog is
# kick-drift with the half step, then kick with damping at the end
# (core.forces._leapfrog_step).
_STAGES = {
    "euler": ((1.0, True, True),),
    "leapfrog": ((0.5, False, True), (0.5, True, False)),
}


@functools.partial(jax.jit, static_argnames=("cfg", "interpret", "tile_elems"))
def _force_step_batched(
    pos, vel, ptype, alive, dt, cfg: SimConfig, interpret=False,
    tile_elems=TILE_ELEMS,
):
    """Kernel over a batch: pos/vel (B, P, 2), ptype/alive (B, P)."""
    b, p = ptype.shape
    layout = block_layout(p, b, tile_elems)
    p2, _, group = layout
    pad_b = (-b) % group
    pads = ((0, pad_b), (0, p2 - p))

    def plane(a):
        return jnp.pad(a.astype(jnp.float32), pads)

    x, y = plane(pos[..., 0]), plane(pos[..., 1])
    vx, vy = plane(vel[..., 0]), plane(vel[..., 1])
    isp = plane(ptype == PROTON)
    m = plane(alive)
    dt = jnp.asarray(dt, jnp.float32)
    for stage in _STAGES[cfg.integrator]:
        x, y, vx, vy = _sweep(dt, x, y, vx, vy, isp, m, cfg, layout, stage,
                              interpret)
    new_pos = jnp.stack([x[:b, :p], y[:b, :p]], axis=-1)
    new_vel = jnp.stack([vx[:b, :p], vy[:b, :p]], axis=-1)
    return new_pos, new_vel


def force_step_pallas(pos, vel, ptype, alive, dt, cfg: SimConfig, interpret=False):
    """Drop-in replacement for :func:`pyqmd_tpu.core.forces.force_step`.

    Accepts unbatched (P, 2) state (adds a singleton batch) or batched
    (B, P, 2) state. Call it batch-native for ensembles, so that small
    nuclei share programs (see ``ensemble_step``).
    """
    if pos.ndim == 2:
        new_pos, new_vel = _force_step_batched(
            pos[None], vel[None], ptype[None], alive[None], dt, cfg, interpret
        )
        return new_pos[0], new_vel[0]
    return _force_step_batched(pos, vel, ptype, alive, dt, cfg, interpret)
