"""Adaptive-precision statistics for the port's Monte Carlo sweeps.

Own copy of the reference package's ``repro.core.variance``, plain
numpy: ``batch_means_stats`` turns the sweeps' Welford batch-means
triple into error bars, ``allocate_cycles`` spends them (the adaptive
campaign's pilot → refine allocation), and ``cv_adjust`` /
``estimate_beta`` / ``crn_pair_diff`` / ``companion_grid`` /
``companion_reference`` are the control-variate and common-random-
number helpers.  The port's keys follow the same contract as the
reference's ``fold_in`` keys (``core.prng``: a point's words depend on
the seed and its global index only), so a companion grid shares its
target's arrival stream here too.

The reference module's description follows.

Adaptive-precision statistics for the Monte Carlo kernels.

The sweep/fleet/gen kernels accumulate a batch-means variance triple
(running block mean, centered second moment M2, block count — one
Welford update per superstep, ``engine.welford_block``) in their scan
carries.  This module is the host-side layer that turns those device
accumulators into error bars and spends them:

- ``batch_means_stats``: (M2, n_blocks) → mean-latency standard error
  and z·stderr CI half-width per point.  The batch-means argument (see
  docs/theory.md §"Adaptive precision") treats each superstep block of
  service completions as one sample of an approximately uncorrelated
  stationary sequence; regenerative resets at idle instants bound the
  block-to-block correlation.
- ``allocate_cycles``: the pilot-then-refine allocation rule used by
  ``campaign(mode="adaptive")`` — per-point cycle budgets from pilot CI
  half-widths, either to a target half-width (n ∝ (ci/target)²) or
  Neyman-proportional (n ∝ stderr) under a fixed refine budget, always
  quantized to power-of-two multiples of the pilot length so the
  refine pass compiles at most a handful of kernel shapes.
- ``cv_adjust`` / ``estimate_beta``: control-variate adjustment
  y − β·(c_mc − c_ref) where the companion estimate ``c_mc`` shares
  the target's arrival randomness (common random numbers via the
  fold_in key contract) and ``c_ref`` is its known expectation — the
  exact chain mean where the companion is in the banded domain, or the
  Theorem-2 bound φ outside it (then the adjustment carries a bias
  ≤ β·(bound gap); see the docs section).
- ``crn_pair_diff``: paired A−B differencing for policy/routing
  comparisons run under shared per-point keys.

Everything here is plain numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["Z95", "batch_means_stats", "allocate_cycles", "cv_adjust",
           "estimate_beta", "crn_pair_diff", "companion_grid",
           "companion_reference"]

# two-sided 95% normal quantile — the default CI level everywhere
Z95 = 1.959963984540054


def batch_means_stats(bm_m2, bm_n, z: float = Z95):
    """Standard error and CI half-width from the kernels' batch-means
    accumulators.

    ``bm_m2`` is the centered second moment Σ (x_j − x̄)² of the block
    means, ``bm_n`` the number of blocks that completed ≥1 measured
    job.  Returns ``(stderr, halfwidth)`` (f64), NaN where fewer than
    two blocks exist (no variance information — e.g. a zero-rate
    point, or a run too short for two supersteps of completions)."""
    m2 = np.asarray(bm_m2, dtype=np.float64)
    n = np.asarray(bm_n, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        var = m2 / np.maximum(n - 1.0, 1.0)
        stderr = np.sqrt(np.maximum(var, 0.0) / np.maximum(n, 1.0))
    stderr = np.where(n >= 2.0, stderr, np.nan)
    return stderr, z * stderr


def allocate_cycles(ci, pilot: int, *, n_max: int,
                    target_ci: Optional[float] = None,
                    refine_budget: Optional[int] = None,
                    safety: float = 1.0) -> np.ndarray:
    """Per-point cycle allocation from pilot CI half-widths.

    Every point gets at least ``pilot`` cycles; allocations above the
    pilot are quantized UP to power-of-two multiples of it (so a refine
    pass compiles at most log2(n_max/pilot) kernel shapes) and capped
    at ``n_max``.  Exactly one of the two policies applies:

    - ``target_ci``: a point needing half-width ≤ target gets
      ``pilot · ceil_pow2(safety · (ci/target)²)`` cycles — the CLT
      1/√n scaling of the batch-means half-width.  ``safety`` > 1 pads
      against the pilot's noisy variance-of-variance.
    - ``refine_budget``: classic Neyman allocation of a fixed extra
      budget, extra_i ∝ ci_i (∝ stderr), then the same quantization.

    NaN half-widths (no variance information) stay at the pilot
    allocation: a point that produced fewer than two completing blocks
    in the pilot has nothing to refine toward.  The returned array is a
    pure function of its inputs — given the same pilot measurements the
    schedule is deterministic, which is what keeps the adaptive
    campaign reproducible end to end."""
    if (target_ci is None) == (refine_budget is None):
        raise ValueError("allocate_cycles needs exactly one of "
                         "target_ci / refine_budget")
    ci = np.asarray(ci, dtype=np.float64)
    if pilot < 1 or n_max < pilot:
        raise ValueError(f"need 1 <= pilot <= n_max "
                         f"(got pilot={pilot}, n_max={n_max})")
    known = np.isfinite(ci) & (ci > 0)
    if target_ci is not None:
        if target_ci <= 0:
            raise ValueError(f"target_ci must be > 0 (got {target_ci})")
        factor = np.where(known, safety * (ci / target_ci) ** 2, 1.0)
    else:
        w = np.where(known, ci, 0.0)
        tot = w.sum()
        extra = (refine_budget * w / tot) if tot > 0 else w
        factor = (pilot + extra) / pilot
    factor = np.maximum(factor, 1.0)
    k = np.ceil(np.log2(factor) - 1e-12).astype(np.int64)
    alloc = np.minimum(pilot * (1 << np.maximum(k, 0)), n_max)
    return alloc.astype(np.int64)


def estimate_beta(stderr_y, stderr_c, clip: float = 2.0) -> np.ndarray:
    """Per-point control-variate coefficient β̂ from the two arms'
    batch-means standard errors.

    The optimal coefficient is β* = ρ·σ_y/σ_c; under common random
    numbers the target and its companion share the arrival stream, so
    ρ ≈ 1 and the observable ratio σ̂_y/σ̂_c is the natural plug-in.
    Clipped to [0, ``clip``] and pinned to 1 where either stderr is
    unavailable.  Any deterministic β keeps the adjustment unbiased;
    a DATA-dependent β̂ like this one reintroduces an O(1/n) bias —
    see docs/theory.md for why that trade is worth it here."""
    sy = np.asarray(stderr_y, dtype=np.float64)
    sc = np.asarray(stderr_c, dtype=np.float64)
    ok = np.isfinite(sy) & np.isfinite(sc) & (sc > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        beta = np.where(ok, sy / np.maximum(sc, 1e-300), 1.0)
    return np.clip(beta, 0.0, clip)


def cv_adjust(y, c_mc, c_ref, beta=None):
    """Control-variate adjustment ``y − β·(c_mc − c_ref)``.

    ``y`` is the MC estimate of interest, ``c_mc`` a companion MC
    estimate sharing its randomness (CRN), ``c_ref`` the companion's
    reference expectation (exact chain mean, or the Theorem-2 bound φ
    with the bias caveat).  ``beta`` defaults to 1 — unbiased for any
    fixed coefficient, and near-optimal when the arms are strongly
    coupled."""
    y = np.asarray(y, dtype=np.float64)
    err = np.asarray(c_mc, dtype=np.float64) - np.asarray(
        c_ref, dtype=np.float64)
    b = 1.0 if beta is None else np.asarray(beta, dtype=np.float64)
    return y - b * err


def crn_pair_diff(res_a, res_b, z: float = Z95) -> dict:
    """Paired A−B mean-latency difference under common random numbers.

    ``res_a``/``res_b`` are result objects (SweepResult/FleetResult/
    GenResult) from two dispatches that differ only in the policy axis
    under study and were run with the SAME seed/key_offset — the
    fold_in contract then gives point i of both grids the same key,
    hence the same arrival stream, so the difference cancels the
    shared arrival noise.  Returns the per-point difference, a
    conservative stderr bound √(s_a² + s_b²) (CRN makes the true
    stderr smaller whenever the arms are positively coupled), and the
    z·stderr half-width."""
    da = np.asarray(res_a.mean_latency, dtype=np.float64)
    db = np.asarray(res_b.mean_latency, dtype=np.float64)
    if da.shape != db.shape:
        raise ValueError(f"paired results must have equal point counts "
                         f"(got {da.shape} vs {db.shape})")
    sa = np.asarray(res_a.stderr, dtype=np.float64)
    sb = np.asarray(res_b.stderr, dtype=np.float64)
    se = np.sqrt(sa ** 2 + sb ** 2)
    return {"diff": da - db, "stderr": se, "halfwidth": z * se}


def companion_grid(grid):
    """The deterministic-service copy of a sweep grid, for use as a
    CRN control-variate companion.

    Point i of the companion receives the same fold_in key as point i
    of ``grid``, and the kernels draw the arrival stream from the same
    key splits regardless of the service family — so companion and
    target share arrivals exactly, differing only in service noise."""
    import dataclasses
    return dataclasses.replace(grid, dist=np.zeros_like(grid.dist))


def companion_reference(grid, **solve_kw):
    """Reference mean latency of the det-service companion, point by
    point: the exact truncated-chain mean where the point is in the
    banded domain (finite b_max), the Theorem-2 bound φ where it is
    not (b_max = 0 ⇒ infinite; the bound-as-CV bias applies there).

    Returns ``(ref, exact_mask)``."""
    from repro_torch.core import analytic, markov

    n = len(grid)
    ref = np.empty(n, dtype=np.float64)
    exact = np.asarray(grid.b_max) >= 1
    for i in range(n):
        model = analytic.LinearServiceModel(float(grid.alpha[i]),
                                            float(grid.tau0[i]))
        if exact[i]:
            ref[i] = markov.solve(float(grid.lam[i]), model,
                                  b_max=int(grid.b_max[i]),
                                  **solve_kw).mean_latency
        else:
            ref[i] = analytic.phi(float(grid.lam[i]), model.alpha,
                                  model.tau0)
    return ref, exact
