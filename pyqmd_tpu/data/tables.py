"""Dense (Z, N)-indexed device tables for in-jit nuclear-data lookups.

The reference consults Python dicts from host code on every decay event
(HALF_LIVES at decay_chains.py:257-262, DECAY_CHAINS at :208-229, with the
predictor mutating the chain dict as a cache at :169-201). Here a decay
happens *inside* the compiled step, so all of that becomes table gathers:
this module densifies the half-life DB, the branch DB (tabulated entries
plus the N/Z-ratio predictor applied to every other grid cell), and the
semi-empirical estimator's bucket bounds into flat numpy arrays that XLA
embeds as constants. Lookups are then pure `jnp.take` + `where` chains.

Grid: Z in [0, 128), N in [0, 192) — comfortably beyond the heaviest
tabulated isotope (Pu-244 = Z 94, N 150) and every reachable daughter.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pyqmd_tpu.data import chains as _chains
from pyqmd_tpu.data import estimator as _est
from pyqmd_tpu.data.halflives import HALF_LIVES
from pyqmd_tpu.state import DECAY_NONE

Z_DIM = 128
N_DIM = 192
_CELLS = Z_DIM * N_DIM


def _build() -> dict[str, np.ndarray]:
    hl_tab = np.full((_CELLS,), np.nan, np.float32)
    est_stable = np.zeros((_CELLS,), bool)
    est_lo = np.zeros((_CELLS,), np.float32)
    est_span = np.zeros((_CELLS,), np.float32)
    est_scale = np.ones((_CELLS,), np.float32)
    br_z = np.zeros((_CELLS, 2), np.int32)
    br_n = np.zeros((_CELLS, 2), np.int32)
    br_t = np.full((_CELLS, 2), DECAY_NONE, np.int32)
    br_p0 = np.ones((_CELLS,), np.float32)

    for z in range(Z_DIM):
        for n in range(N_DIM):
            i = z * N_DIM + n
            # Half-life: tabulated value (inf = stable) or NaN = "estimate".
            if (z, n) in HALF_LIVES:
                hl_tab[i] = np.float32(HALF_LIVES[(z, n)])
            score = _est.stability_score(z, n)
            est_stable[i] = score >= _est.STABLE_THRESHOLD
            lo, hi, scale = _est.bucket_params(score)
            est_lo[i] = lo
            est_span[i] = hi - lo
            est_scale[i] = scale
            # Decay branches: tabulated chain or pure predictor. Single-branch
            # entries are duplicated into slot 1 so the sampling rule
            # "branch 1 iff r > p0" can never select a wrong daughter
            # (the reference falls back to options[0] on a non-match,
            # decay_chains.py:223-229).
            branches = _chains.decay_branches(z, n)
            b0 = branches[0]
            b1 = branches[1] if len(branches) > 1 else b0
            br_z[i] = (b0[0], b1[0])
            br_n[i] = (b0[1], b1[1])
            br_t[i] = (b0[2], b1[2])
            br_p0[i] = b0[3] if len(branches) > 1 else 1.0

    return dict(
        hl_tab=hl_tab, est_stable=est_stable, est_lo=est_lo,
        est_span=est_span, est_scale=est_scale,
        br_z=br_z, br_n=br_n, br_t=br_t, br_p0=br_p0,
    )


_T = _build()

# Packed row table: every per-cell field in one (CELLS, 16) f32 row, so a
# decay event costs TWO row gathers (parent cell for the branch data,
# daughter cell for the half-life) instead of nine flat-table gathers —
# each gather is its own fusion, and at batch=1 the decay path is
# bound by fusion latency. Integer fields ride as exact f32 (all values
# << 2^24); rows pad to 16 columns.
# Layout: 0 hl_tab, 1 est_lo, 2 est_span, 3 est_scale, 4 est_stable,
#         5 br_p0, 6-8 br_z0/br_n0/br_t0, 9-11 br_z1/br_n1/br_t1.
_ROWS = np.zeros((_CELLS, 16), np.float32)
_ROWS[:, 0] = _T["hl_tab"]
_ROWS[:, 1] = _T["est_lo"]
_ROWS[:, 2] = _T["est_span"]
_ROWS[:, 3] = _T["est_scale"]
_ROWS[:, 4] = _T["est_stable"].astype(np.float32)
_ROWS[:, 5] = _T["br_p0"]
_ROWS[:, 6] = _T["br_z"][:, 0]
_ROWS[:, 7] = _T["br_n"][:, 0]
_ROWS[:, 8] = _T["br_t"][:, 0]
_ROWS[:, 9] = _T["br_z"][:, 1]
_ROWS[:, 10] = _T["br_n"][:, 1]
_ROWS[:, 11] = _T["br_t"][:, 1]


def lookup_row(z, n):
    """One (16,) packed data row for isotope (z, n) — see layout above."""
    return jnp.take(jnp.asarray(_ROWS), _flat_index(z, n), axis=0)


def half_life_from_row(row, u):
    """:func:`half_life` over a pre-gathered packed row."""
    est = jnp.where(
        row[..., 4] > 0.5,
        jnp.inf,
        jnp.exp2(jnp.log2(10.0) * (row[..., 1] + u * row[..., 2])) * row[..., 3],
    )
    return jnp.where(jnp.isnan(row[..., 0]), est, row[..., 0]).astype(jnp.float32)


def sample_branch_from_row(row, r):
    """:func:`sample_branch` over a pre-gathered packed row."""
    pick1 = r > row[..., 5]
    new_z = jnp.where(pick1, row[..., 9], row[..., 6]).astype(jnp.int32)
    new_n = jnp.where(pick1, row[..., 10], row[..., 7]).astype(jnp.int32)
    dtype = jnp.where(pick1, row[..., 11], row[..., 8]).astype(jnp.int32)
    return new_z, new_n, dtype


def _flat_index(z, n):
    zc = jnp.clip(z, 0, Z_DIM - 1).astype(jnp.int32)
    nc = jnp.clip(n, 0, N_DIM - 1).astype(jnp.int32)
    return zc * N_DIM + nc


def half_life(z, n, u):
    """Half-life in seconds for isotope (z, n); ``u`` is a U(0,1) draw.

    Tabulated isotopes are deterministic; untabulated ones get the keyed
    semi-empirical estimate (reference: decay_chains.py:247-328, where the
    draw happens uncontrollably inside the function).
    """
    i = _flat_index(z, n)
    tab = jnp.take(_T["hl_tab"], i)
    lo = jnp.take(_T["est_lo"], i)
    span = jnp.take(_T["est_span"], i)
    scale = jnp.take(_T["est_scale"], i)
    stable = jnp.take(_T["est_stable"], i)
    est = jnp.where(
        stable,
        jnp.inf,
        jnp.exp2(jnp.log2(10.0) * (lo + u * span)) * scale,
    )
    return jnp.where(jnp.isnan(tab), est, tab).astype(jnp.float32)


def sample_branch(z, n, r):
    """Sample a decay branch: returns (new_z, new_n, decay_type).

    ``r`` is a U(0,1) draw; branch 1 is taken iff ``r > p0`` (cumulative
    sampling over at most two branches, decay_chains.py:218-229 semantics).
    """
    i = _flat_index(z, n)
    pick1 = r > jnp.take(_T["br_p0"], i)
    sel = pick1.astype(jnp.int32)
    new_z = jnp.take(_T["br_z"].reshape(-1), i * 2 + sel)
    new_n = jnp.take(_T["br_n"].reshape(-1), i * 2 + sel)
    dtype = jnp.take(_T["br_t"].reshape(-1), i * 2 + sel)
    return new_z, new_n, dtype


def half_life_host(z: int, n: int, u: float = 0.5) -> float:
    """Host-side (non-jit) half-life lookup for CLI/tests."""
    if (z, n) in HALF_LIVES:
        return float(HALF_LIVES[(z, n)])
    return _est.estimate_half_life(z, n, u)
