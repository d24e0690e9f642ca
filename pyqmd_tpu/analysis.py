"""Ensemble analysis: survival curves, decay statistics, half-life fits.

The reference can only watch one nucleus decay at a time
(/root/reference/nuclear_sim.py:48); the population-statistics workflow —
N independent nuclei, survival fraction vs exp(-lambda t), half-life
estimation — is this build's headline capability (BASELINE north star:
C-14 ensemble half-life within 1% of the tabulated value).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

import jax

from pyqmd_tpu.config import SimConfig
from pyqmd_tpu.core.init import ensemble_init
from pyqmd_tpu.core.step import make_decay_frame_fn, make_frame_fn
from pyqmd_tpu.data.tables import half_life_host


# Jitted survivor count — one program dispatch and one scalar readback per
# frame instead of three eager op dispatches (z/n ride as traced scalars,
# so isotope changes don't recompile).
_count_isotope = jax.jit(lambda mz, mn, z, n: ((mz == z) & (mn == n)).sum())


@dataclasses.dataclass
class SurvivalResult:
    """Survival-curve measurement for one isotope ensemble."""

    z: int
    n: int
    batch: int
    times: np.ndarray  # (F+1,) sim seconds
    survival: np.ndarray  # (F+1,) fraction still the initial isotope
    decay_counts: np.ndarray  # (NUM_DECAY_TYPES,) totals at the end
    tabulated_half_life: float
    fitted_half_life: float

    @property
    def rel_error(self) -> float:
        if not math.isfinite(self.tabulated_half_life):
            return float("nan")
        return abs(self.fitted_half_life - self.tabulated_half_life) / (
            self.tabulated_half_life
        )

    def activity(self) -> np.ndarray:
        """Decays per second at each time point (A = -dN/dt), the quantity
        a detector measures; A(t) = lambda*N(t) for a pure species."""
        return -np.gradient(self.survival * self.batch, self.times)

    def to_csv(self) -> str:
        lines = ["time_s,survival,activity_per_s"]
        act = self.activity()
        lines += [
            f"{t},{s},{a}" for t, s, a in zip(self.times, self.survival, act)
        ]
        return "\n".join(lines) + "\n"


def _ensemble_setup(
    z, n, batch, frames, half_lives, substeps, seed, pad_to, decay_only,
    max_chain_log, overrides,
):
    """Shared measurement preamble of :func:`survival_curve` and
    :func:`chain_populations`: stability check, config build (with
    optional SimConfig field ``overrides`` — the CLI's ``--set`` surface),
    ensemble init, frame-fn selection and the time-grid step. One
    helper so a validation or plumbing fix cannot drift between the two."""
    if frames < 1:
        raise ValueError(f"frames must be >= 1, got {frames}")
    hl = half_life_host(z, n)
    if not math.isfinite(hl):
        raise ValueError(f"isotope ({z},{n}) is stable; no half-life to measure")
    cfg = SimConfig.for_isotope(z, n, pad_to=pad_to, max_chain_log=max_chain_log)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    states = ensemble_init(cfg, batch, seed=seed)
    fn = (
        make_decay_frame_fn(cfg, substeps)
        if decay_only
        else make_frame_fn(cfg, substeps, batched=True)
    )
    return hl, cfg, states, fn, half_lives * hl / frames


def survival_curve(
    z: int,
    n: int,
    batch: int = 4096,
    frames: int = 20,
    half_lives: float = 2.0,
    substeps: int = 10,
    seed: int = 0,
    pad_to: int = 8,
    decay_only: bool = True,
    max_chain_log: int = 8,
    overrides: dict | None = None,
) -> SurvivalResult:
    """Run a `batch`-nucleus ensemble of isotope (z, n) for `half_lives`
    tabulated half-lives and record the survival curve.

    The MLE half-life fit uses the endpoint survivor count:
    ``T = ln2 * t_end / -ln(S)``.

    ``decay_only=True`` (default) skips forces/ejecta/overlap — the
    isotope trajectories are bitwise identical either way (see
    :func:`pyqmd_tpu.core.step.decay_ensemble_step`), orders of magnitude
    cheaper for heavy isotopes; pass False to pay for full dynamics.

    ``max_chain_log`` sizes the per-member chain-log ring. Statistics
    workflows never read it, but it IS per-substep HBM traffic (measured
    1.4x at a 2M ensemble going 64 -> 8); raise it if you also want deep
    per-member event logs out of the run.

    ``overrides`` replaces arbitrary SimConfig fields (the CLI ``--set``
    surface), e.g. ``{"strong_strength": 120.0}`` for what-if physics.
    """
    hl, cfg, states, fn, sim_dt = _ensemble_setup(
        z, n, batch, frames, half_lives, substeps, seed, pad_to,
        decay_only, max_chain_log, overrides,
    )

    times = [0.0]
    survival = [1.0]
    m = None
    for f in range(frames):
        states, m = fn(states, sim_dt, 1.0)
        # Jitted on-device reduction, ONE scalar readback per frame.
        alive = int(_count_isotope(m["z"], m["n"], z, n))
        times.append((f + 1) * sim_dt)
        survival.append(alive / batch)

    s_end = survival[-1]
    if s_end >= 1.0:
        # No member ever left the initial isotope: zero decays in the
        # window, or a chain whose branches re-enter (z, n) (Tc-99m's γ
        # branch, data/chains.py) — the endpoint MLE carries no
        # information. -log(1.0) is -0.0, so the division would crash;
        # report an infinite fit instead.
        fitted = math.inf
    else:
        fitted = math.log(2) * times[-1] / -math.log(max(s_end, 1e-12))
    return SurvivalResult(
        z=z,
        n=n,
        batch=batch,
        times=np.asarray(times),
        survival=np.asarray(survival),
        decay_counts=np.asarray(m["total_decay_counts"]),
        tabulated_half_life=hl,
        fitted_half_life=fitted,
    )


def chain_populations(
    z: int,
    n: int,
    batch: int = 4096,
    frames: int = 30,
    half_lives: float = 3.0,
    substeps: int = 10,
    seed: int = 0,
    pad_to: int = 8,
    decay_only: bool = True,
    max_chain_log: int = 8,
    overrides: dict | None = None,
) -> dict:
    """Track the isotope populations of a decaying ensemble over time.

    Runs a `batch`-nucleus ensemble of (z, n) and, each frame, histograms
    the per-nucleus (Z, N) — the population view of the reference's
    decay-chain panel (rendering.py:248-380), resolved statistically: e.g.
    a U-238 ensemble shows daughters flowing down the chain toward secular
    equilibrium. Returns ``{"times": [...], "populations": {"Z:N": [...]}}``
    whose keys are the reachable chain nodes (:func:`decay_chain_graph`),
    plus an ``"other"`` row if any member leaves the predicted graph.
    ``decay_only`` as in :func:`survival_curve`.

    The histogram is computed ON DEVICE against the chain-node list, so
    host readback is O(nodes) scalars per frame, not O(batch) — at a
    2M-nucleus ensemble the per-frame readback drops from ~16 MB of
    (Z, N) arrays to a few hundred bytes.
    """
    import jax.numpy as jnp

    hl, cfg, states, fn, sim_dt = _ensemble_setup(
        z, n, batch, frames, half_lives, substeps, seed, pad_to,
        decay_only, max_chain_log, overrides,
    )

    nodes, _ = decay_chain_graph(z, n)
    node_z = jnp.asarray([zz for zz, _ in nodes], jnp.int32)
    node_n = jnp.asarray([nn for _, nn in nodes], jnp.int32)

    @jax.jit
    def hist(zs, ns):
        eq = (zs[:, None] == node_z[None, :]) & (ns[:, None] == node_n[None, :])
        counts = jnp.sum(eq, axis=0)
        return counts, zs.shape[0] - jnp.sum(counts)

    keys = [f"{zz}:{nn}" for zz, nn in nodes]
    times = [0.0]
    pops: dict[str, list[int]] = {k: [0] for k in keys}
    pops[f"{z}:{n}"][0] = batch
    other: list[int] = [0]
    for f in range(frames):
        states, m = fn(states, sim_dt, 1.0)
        # ONE combined host transfer per frame (each readback is a
        # device sync).
        counts, extra = jax.device_get(hist(m["z"], m["n"]))
        times.append((f + 1) * sim_dt)
        for k, c in zip(keys, counts):
            pops[k].append(int(c))
        other.append(int(extra))
    if any(other):
        pops["other"] = other
    return {"times": times, "populations": pops}


def chain_populations_csv(result: dict) -> str:
    """CSV form of a :func:`chain_populations` result (one column per
    isotope, rows = time points). Also accepts a
    :func:`bateman_populations` result — the dicts share a shape, so the
    measured and theoretical curves export identically."""
    keys = sorted(result["populations"])
    lines = ["time_s," + ",".join(keys)]
    for t_idx, t in enumerate(result["times"]):
        row = [str(t)] + [str(result["populations"][k][t_idx]) for k in keys]
        lines.append(",".join(row))
    return "\n".join(lines) + "\n"


def _chain_walk(
    z: int, n: int, max_nodes: int
) -> tuple[
    list[tuple[int, int]],
    list[tuple[int, int, float]],
    list[tuple],
]:
    """BFS over the reachable decay DAG shared by the graph builders.

    Returns ``(nodes, edges, specs)``: isotopes in BFS order, real-branch
    edges ``(parent_idx, child_idx, renormalized_prob)``, and one sojourn
    spec per node describing how the engine draws its half-life
    (core/decay.py daughter refresh — one U(0,1) draw per nucleus on
    arrival, data/tables.py:half_life):

    - ``("stable",)`` — infinite/zero half-life or no real decay mode,
    - ``("exp", lam)`` — tabulated: a single exponential rate,
    - ``("mix", lo, hi, scale)`` — estimator bucket: per-nucleus half-life
      ``10**(lo + U(0,1)*(hi-lo)) * scale`` (decay_chains.py:309-328).
    """
    from pyqmd_tpu.data.chains import decay_branches
    from pyqmd_tpu.data.estimator import (
        STABLE_THRESHOLD,
        bucket_params,
        stability_score,
    )
    from pyqmd_tpu.data.halflives import HALF_LIVES
    from pyqmd_tpu.state import DECAY_NONE

    nodes: list[tuple[int, int]] = [(z, n)]
    index = {(z, n): 0}
    edges: list[tuple[int, int, float]] = []  # (parent_idx, child_idx, prob)
    specs: list[tuple] = []
    i = 0
    while i < len(nodes):
        zz, nn = nodes[i]
        branches = [
            b for b in decay_branches(zz, nn) if b[2] != DECAY_NONE
        ]
        spec: tuple = ("stable",)
        if branches:
            if (zz, nn) in HALF_LIVES:
                hl = float(HALF_LIVES[(zz, nn)])
                if math.isfinite(hl) and hl > 0:
                    spec = ("exp", math.log(2) / hl)
            else:
                score = stability_score(zz, nn)
                if score < STABLE_THRESHOLD:
                    spec = ("mix",) + bucket_params(score)
        specs.append(spec)
        if spec[0] != "stable":
            total = sum(b[3] for b in branches)
            for bz, bn, _mode, prob in branches:
                key = (bz, bn)
                if key not in index:
                    if len(nodes) >= max_nodes:
                        raise ValueError(
                            f"decay graph of ({z},{n}) exceeds {max_nodes} nodes"
                        )
                    index[key] = len(nodes)
                    nodes.append(key)
                edges.append((i, index[key], prob / total))
        i += 1
    return nodes, edges, specs


def decay_chain_graph(
    z: int, n: int, max_nodes: int = 128
) -> tuple[list[tuple[int, int]], np.ndarray]:
    """Reachable-isotope decay DAG rooted at (z, n).

    Returns ``(nodes, rates)``: the isotopes reachable through the chain
    database (tabulated chains + the N/Z-ratio predictor for untabulated
    isotopes, decay_chains.py:126-201) in BFS order, and the (K, K) rate
    matrix A of the linear decay ODE dN/dt = A·N — A[j][j] = -λ_j and
    A[child][parent] = λ_parent · branch_probability. Stable nuclides
    (infinite half-life or a NONE mode) have λ = 0. Branch probabilities
    are renormalized to sum to 1 over real decay modes (the predictor
    reports a lone branch as 0.9, mirroring the reference).

    Estimator-bucket nodes get the deterministic log-midpoint rate
    (u = 0.5) — a single-λ summary view. The ``bateman_*`` functions do
    NOT use this matrix for such nodes: they expand the bucket's
    log-uniform half-life distribution exactly (see
    :func:`_expanded_decay_graph`).
    """
    nodes, edges, specs = _chain_walk(z, n, max_nodes)
    lam: list[float] = []
    for spec in specs:
        if spec[0] == "exp":
            lam.append(spec[1])
        elif spec[0] == "mix":
            lo, hi, scale = spec[1:]
            lam.append(math.log(2) / (10.0 ** (lo + 0.5 * (hi - lo)) * scale))
        else:
            lam.append(0.0)
    k = len(nodes)
    a = np.zeros((k, k), np.float64)
    for j in range(k):
        a[j, j] = -lam[j]
    for p, c, prob in edges:
        a[c, p] += lam[p] * prob
    return nodes, a


def _expanded_decay_graph(
    z: int, n: int, max_nodes: int = 128, quad: int = 32
) -> tuple:
    """Hyperexponential expansion of the decay DAG: the EXACT ensemble
    expectation under the engine's half-life sampling.

    The engine draws an estimated isotope's half-life once per nucleus on
    arrival, log-uniformly over the estimator bucket (core/decay.py
    daughter refresh; decay_chains.py:309-328) — so a bucket node's
    sojourn time is a *mixture* of exponentials, and the population is
    not a single-rate ODE. But a mixture of exponentials is exactly a
    probabilistic fan-out into exponential sub-states: replace each
    bucket node with ``quad`` Gauss-Legendre sub-states (rate
    λ_m = ln2 / T(u_m), arrival weight w_m), and the expanded system is a
    linear ODE again — exact up to 1-D quadrature of the smooth
    E[exp(-λ(u)·t)] integrand, with no cross-node coupling because each
    nucleus's draws at different nodes are independent and a DAG is
    visited at most once.

    Returns ``(nodes, a, state_of, entry_w, lam_s, out_frac)``: public
    BFS nodes, the (S, S) expanded rate matrix, each node's
    expanded-state indices and arrival weights, the per-state rates, and
    each state's outflow fractions (for the stiffness elimination in
    :func:`_expanded_pops`).
    """
    nodes, edges, specs = _chain_walk(z, n, max_nodes)
    state_of: list[np.ndarray] = []
    entry_w: list[np.ndarray] = []
    lam_all: list[float] = []
    for spec in specs:
        if spec[0] == "mix":
            lo, hi, scale = spec[1:]
            x, w = np.polynomial.legendre.leggauss(quad)
            u = 0.5 * (x + 1.0)
            w = 0.5 * w
            lam = math.log(2) / (10.0 ** (lo + u * (hi - lo)) * scale)
        elif spec[0] == "exp":
            lam, w = np.array([spec[1]]), np.array([1.0])
        else:
            lam, w = np.array([0.0]), np.array([1.0])
        idx = np.arange(len(lam_all), len(lam_all) + lam.size)
        state_of.append(idx)
        entry_w.append(w)
        lam_all.extend(lam.tolist())
    lam_s = np.asarray(lam_all, np.float64)
    s = lam_s.size
    a = np.zeros((s, s), np.float64)
    a[np.arange(s), np.arange(s)] = -lam_s
    # Per-state outflow fractions (sum to 1 for decaying states): the
    # branch probability times the child's arrival quadrature weight.
    out_frac: list[list[tuple[int, float]]] = [[] for _ in range(s)]
    for p, c, prob in edges:
        for sp in state_of[p]:
            a[state_of[c], sp] += lam_s[sp] * prob * entry_w[c]
            for sc, wc in zip(state_of[c], entry_w[c]):
                out_frac[sp].append((int(sc), prob * float(wc)))
    return nodes, a, state_of, entry_w, lam_s, out_frac


def _expm_taylor(m: np.ndarray) -> np.ndarray:
    """Matrix exponential by scaling-and-squaring + Taylor — the no-scipy
    fallback for :func:`bateman_populations`. Unlike plain
    eigendecomposition it stays finite for *defective* rate matrices
    (e.g. two chained isotopes that happen to share a decay constant)."""
    norm = float(np.linalg.norm(m, 1))
    k = max(0, int(np.ceil(np.log2(norm)))) + 1 if norm > 1e-300 else 0
    a = m / (2.0 ** k)
    out = np.eye(m.shape[0])
    term = np.eye(m.shape[0])
    for i in range(1, 40):
        term = term @ a / i
        out = out + term
        if np.abs(term).max() < 1e-18:
            break
    for _ in range(k):
        out = out @ out
    return out


_FAST_LAMT = 1e4  # λ·t above this → exp(-λ·t) ≡ 0 in f64 (e^-1e4 underflows)


def _expanded_pops(
    z: int, n: int, times: np.ndarray, max_nodes: int, quad: int
):
    """Shared solver: expanded-state populations at each time.

    Stiffness handling: the expansion's fastest sub-states (a
    microsecond-bucket node holds rates up to ~7e5/s) make expm(A·t)
    overflow at geological times. A state with λ·t > ``_FAST_LAMT`` is
    numerically EMPTY at time t (its survival underflows to exactly 0.0)
    and acts as an instantaneous router: per evaluation time, such states
    are eliminated by forwarding their inflow (initial mass and incoming
    rate terms) directly to their slow descendants through the outflow
    fractions. This is an O(1/(λ·t)) ≤ ~1e-4 approximation, NOT exact:
    an eliminated state's true quasi-steady population (~inflow/λ) is
    reported as 0.0 and the 1/λ holdup delay on downstream inflow is
    dropped — measured continuity across the threshold is ~4e-6, fine
    for the engine's 1% statistical bar but not for tighter validation.
    The elimination also bounds the reduced matrix norm so expm stays
    well-conditioned at every t.

    Returns ``(nodes, state_of, lam_s, pops, times)`` with ``pops`` of
    shape (T, S) over expanded states.
    """
    try:
        from scipy.linalg import expm
    except ImportError:  # pragma: no cover - scipy is in the image
        expm = _expm_taylor

    nodes, a, state_of, entry_w, lam_s, out_frac = _expanded_decay_graph(
        z, n, max_nodes=max_nodes, quad=quad
    )
    times = np.asarray(times, np.float64)
    s = lam_s.size
    n0 = np.zeros(s, np.float64)
    n0[state_of[0]] = entry_w[0]
    pops = np.empty((times.size, s), np.float64)
    for ti, t in enumerate(times.reshape(-1)):
        t = float(t)
        fast = lam_s * t > _FAST_LAMT
        if not fast.any():
            pops[ti] = np.real(expm(a * t) @ n0)
            continue
        # Route mass entering a fast state to its slow descendants (the
        # decay graph is a DAG, so the recursion terminates).
        memo: dict[int, list[tuple[int, float]]] = {}

        def route(si: int) -> list[tuple[int, float]]:
            if not fast[si]:
                return [(si, 1.0)]
            got = memo.get(si)
            if got is None:
                acc: dict[int, float] = {}
                for sc, f in out_frac[si]:
                    for st2, f2 in route(sc):
                        acc[st2] = acc.get(st2, 0.0) + f * f2
                got = memo[si] = list(acc.items())
            return got

        slow = np.flatnonzero(~fast)
        pos = {int(si): j for j, si in enumerate(slow)}
        n0r = np.zeros(slow.size, np.float64)
        for si in range(s):
            if n0[si]:
                for st2, f in route(si):
                    n0r[pos[st2]] += n0[si] * f
        ar = np.zeros((slow.size, slow.size), np.float64)
        for j, si in enumerate(slow):
            si = int(si)
            ar[j, j] = -lam_s[si]
            for sc, f in out_frac[si]:
                for st2, f2 in route(sc):
                    ar[pos[st2], j] += lam_s[si] * f * f2
        row = np.zeros(s, np.float64)
        row[slow] = np.real(expm(ar * t) @ n0r)
        pops[ti] = row
    return nodes, state_of, lam_s, np.clip(pops, 0.0, 1.0), times


def bateman_populations(
    z: int, n: int, times: np.ndarray, max_nodes: int = 128, quad: int = 32
) -> dict:
    """Analytical expected populations of every isotope in the decay chain
    of (z, n) at the given times — the theory curve for
    :func:`chain_populations` (same ``{"times", "populations"}`` shape, but
    population *fractions* of the initial ensemble, not member counts).

    Solves the Bateman equations dN/dt = A·N by matrix exponential, which
    handles the chain DB's branch points (e.g. Po-218, Bi-214) and
    arbitrary-length series without the classical formula's catastrophic
    cancellation for near-equal decay constants. Predictor-estimated
    nodes — whose per-nucleus half-life the engine samples log-uniformly
    from the estimator bucket — are expanded into ``quad``
    Gauss-Legendre exponential sub-states (:func:`_expanded_decay_graph`),
    so the curve is the exact ensemble expectation everywhere, tabulated
    or estimated. The reference has no analytical machinery at all; this
    is the validation companion the statistical workflow needs.
    """
    nodes, state_of, _lam_s, pops, times = _expanded_pops(
        z, n, times, max_nodes, quad
    )
    return {
        "times": times,
        "populations": {
            f"{zz}:{nn}": pops[:, state_of[j]].sum(axis=-1)
            for j, (zz, nn) in enumerate(nodes)
        },
    }


def bateman_activity(z: int, n: int, times: np.ndarray, max_nodes: int = 128) -> dict:
    """Analytical activity curves A_i(t) = λ_i·N_i(t) (decays per second
    per initial nucleus) for every isotope in the chain of (z, n) — the
    theory companion to :func:`SurvivalResult.activity`, resolved per
    species instead of for the parent alone. Same ``{"times",
    "populations"}`` shape as :func:`bateman_populations` (so
    :func:`chain_populations_csv` exports it), with activities in the
    value arrays. For predictor-estimated nodes the activity is the exact
    mixture expectation Σ_m λ_m·N_m(t) over the expanded sub-states
    (:func:`_expanded_decay_graph`), not λ_mid·N(t)."""
    nodes, state_of, lam_s, pops, times = _expanded_pops(
        z, n, times, max_nodes, quad=32
    )
    return {
        "times": times,
        "populations": {
            f"{zz}:{nn}": (pops[:, state_of[j]] * lam_s[state_of[j]]).sum(
                axis=-1
            )
            for j, (zz, nn) in enumerate(nodes)
        },
    }


def decay_rate_summary(result: SurvivalResult) -> dict:
    """Compact JSON-able summary of a survival run."""
    return {
        "isotope": f"{result.z}:{result.n}",
        "batch": result.batch,
        "tabulated_half_life_s": result.tabulated_half_life,
        "fitted_half_life_s": result.fitted_half_life,
        "rel_error": result.rel_error,
        "final_survival": float(result.survival[-1]),
        "decay_counts": result.decay_counts.tolist(),
    }
