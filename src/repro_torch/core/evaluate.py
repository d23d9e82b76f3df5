"""One entry point over the port's queue-evaluation backends.

``evaluate(grid, backend=...)`` mirrors the reference package's
``repro.core.evaluate`` for the backends the port has:

- ``"analytic"`` — closed form only (Theorem 2 + Remark 5 + Lemma 5):
  ``mean_latency`` is the upper bound φ, ``mean_batch`` the Remark-5
  lower bound, ``utilization`` the Lemma-5 upper bound.  Deterministic
  service, infinite b_max, no timeout — other points raise.
- ``"markov"`` — exact truncated-chain numerics on the host (the
  port's copy of ``repro.core.markov``); deterministic service, no
  timeout.  A ``SweepGrid`` goes point by point through
  ``markov.solve`` (``solve_loss`` for q_max reject points, the
  completion-time chain for resume/restart failure points without
  admission control or throttle).  A ``MarkovGrid`` goes through
  ``markov.solve_grid``: the whole (λ, b_max) grid through the batched
  float64 chain solver on the card (``device="cpu"`` on request;
  ``method="numpy"`` for the host loop).
- ``"sim"`` — the scalar numpy event simulator (the port's copy of
  ``repro.core.simulate``), one point at a time; no timeout, loss or
  failure regimes.
- ``"sweep"`` — the PyTorch Monte Carlo sweep (``repro_torch.core
  .sweep``), on CUDA unless ``device="cpu"``; keyword arguments pass
  through to it.
- ``"gen"`` — the token-level generate sweep (``repro_torch.core
  .gen_sweep``), likewise.  It takes a ``GenGrid``, and the
  request-level backends refuse one.

The three sweeps take loss grids (``q_max``, ``deadline``, ``overflow``,
``retry_rate``) and failure grids (``mtbf``, ``mttr``, ``fail_disc``,
``throttle``); their results carry ``goodput_frac``, ``reject_frac``,
``abandon_frac`` and ``retry_inflation``.  ``"analytic"`` refuses both.

Each call returns one ``SimResult`` per point, with the reference's
field names.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from repro_torch.core import analytic as an
from repro_torch.core.grid import (DIST_CODE, DIST_NAME, FleetGrid, GenGrid,
                                   MarkovGrid, SweepGrid)
from repro_torch.core.results import SimResult

__all__ = ["evaluate", "BACKENDS"]

BACKENDS = ("analytic", "markov", "sim", "sweep", "fleet", "gen")


def _require(cond: bool, backend: str, what: str) -> None:
    if not cond:
        raise ValueError(f"backend {backend!r} supports only {what}")


def _analytic(grid: SweepGrid) -> List[SimResult]:
    _require(bool(np.all(grid.dist == DIST_CODE["det"])), "analytic",
             "deterministic service (the paper's Assumption 4 setting)")
    _require(bool(np.all(grid.b_max == 0)), "analytic", "infinite b_max")
    _require(bool(np.all(grid.wait_max == 0.0)), "analytic",
             "the no-wait policy")
    _require(not grid.has_loss, "analytic",
             "lossless points (no q_max/deadline/retry — Theorem 2 "
             "assumes an infinite patient queue)")
    _require(not grid.has_fail, "analytic",
             "failure-free points (Theorem 2 assumes a server that "
             "never breaks down; use backend='markov' with mtbf/mttr "
             "or the MC kernels)")
    out = []
    for i in range(len(grid)):
        lam = float(grid.lam[i])
        a, t0 = float(grid.alpha[i]), float(grid.tau0[i])
        if not an.is_stable(lam, a, t0):
            raise ValueError(f"point {i}: unstable (λα = {lam * a:.3f})")
        out.append(SimResult(
            lam=lam, n_jobs=0,
            mean_latency=float(an.phi(lam, a, t0)),
            mean_batch=float(an.mean_batch_lower(lam, a, t0)),
            batch_m2=float("nan"),
            utilization=float(an.utilization_upper(lam, a, t0)),
            backend="analytic",
        ))
    return out


def _markov(grid: SweepGrid, **kw) -> List[SimResult]:
    from repro_torch.core.markov import solve, solve_loss
    from repro_torch.core.grid import FAIL_DISC_NAME, OVERFLOW_CODE
    _require(bool(np.all(grid.dist == DIST_CODE["det"])), "markov",
             "deterministic service")
    _require(bool(np.all(grid.wait_max == 0.0)), "markov",
             "the no-wait policy")
    if grid.has_fail:
        # the completion-time chain covers the pure breakdown/repair
        # regime; mixing failures with admission control couples the
        # chain to the room/orbit (use the MC kernels + loss_ref)
        failing = grid.mtbf > 0.0
        _require(bool(np.all(~failing
                             | ((grid.q_max == 0)
                                & (grid.deadline == 0.0)
                                & (grid.retry_rate == 0.0)))),
                 "markov", "failure points without admission control "
                 "(no q_max/deadline/retry alongside mtbf)")
        _require(bool(np.all(~failing | (grid.throttle == 1.0))),
                 "markov", "failure points without a degraded phase "
                 "(throttle = 1; the post-repair throttle makes "
                 "service state-dependent across batches)")
    if grid.has_loss:
        # the exact chain covers exactly the finite-waiting-room reject
        # regime; impatience and retry feedback have no embedded-chain
        # representation (use the MC kernels for those)
        _require(bool(np.all(grid.deadline == 0.0)), "markov",
                 "q_max-only loss points (no deadlines)")
        _require(bool(np.all(grid.retry_rate == 0.0)), "markov",
                 "q_max-only loss points (no retry feedback)")
        _require(bool(np.all((grid.q_max == 0)
                             | (grid.overflow
                                == OVERFLOW_CODE["reject"]))),
                 "markov", "the reject ('429') overflow mode")
    out = []
    for i in range(len(grid)):
        b_max = float(grid.b_max[i]) if grid.b_max[i] > 0 else math.inf
        model = an.LinearServiceModel(float(grid.alpha[i]),
                                      float(grid.tau0[i]))
        if grid.has_loss and grid.q_max[i] > 0:
            r = solve_loss(float(grid.lam[i]), model, b_max=b_max,
                           q_max=int(grid.q_max[i]), **kw)
            out.append(SimResult(
                lam=r.lam, n_jobs=0, mean_latency=r.mean_latency,
                mean_batch=r.mean_batch, batch_m2=r.batch_m2,
                utilization=r.utilization, backend="markov",
                goodput_frac=1.0 - r.loss_frac,
                reject_frac=r.loss_frac, abandon_frac=0.0,
                retry_inflation=1.0,
            ))
            continue
        fkw = dict(kw)
        if grid.has_fail and grid.mtbf[i] > 0.0:
            fkw.update(mtbf=float(grid.mtbf[i]),
                       mttr=float(grid.mttr[i]),
                       fail_disc=FAIL_DISC_NAME[int(grid.fail_disc[i])])
        m = solve(float(grid.lam[i]), model, b_max=b_max, **fkw)
        out.append(SimResult(
            lam=m.lam, n_jobs=0, mean_latency=m.mean_latency,
            mean_batch=m.mean_batch, batch_m2=m.batch_m2,
            utilization=m.utilization, backend="markov",
        ))
    return out


def _sim(grid: SweepGrid, **kw) -> List[SimResult]:
    from repro_torch.core.simulate import simulate
    _require(bool(np.all(grid.wait_max == 0.0)), "sim",
             "the no-wait policy (use backend='sweep' for timeouts)")
    _require(not grid.has_loss, "sim",
             "lossless points (the scalar simulator has no admission "
             "control; use backend='sweep' or repro_torch.core.loss_ref)")
    _require(not grid.has_fail, "sim",
             "failure-free points (the scalar simulator has no "
             "breakdown/repair model; use backend='sweep' or "
             "repro_torch.core.loss_ref)")
    out = []
    for i in range(len(grid)):
        b_max = float(grid.b_max[i]) if grid.b_max[i] > 0 else math.inf
        out.append(simulate(
            float(grid.lam[i]),
            an.LinearServiceModel(float(grid.alpha[i]),
                                  float(grid.tau0[i])),
            b_max=b_max, dist=DIST_NAME[int(grid.dist[i])],
            cv=float(grid.cv[i]), **kw))
    return out


def evaluate(grid: SweepGrid, backend: str = "sweep",
             **kw) -> List[SimResult]:
    """Evaluate every grid point with the chosen backend (see module
    docstring); returns one ``SimResult`` per point.  The sweep fills
    each result's ``stderr``/``ci_halfwidth`` (batch means, nominal
    95%); the exact backends leave them NaN."""
    if isinstance(grid, MarkovGrid):
        if backend != "markov":
            # the exact grid has no service-distribution/policy/replica
            # axes — no other backend can read it
            raise ValueError(f"backend {backend!r} cannot evaluate a "
                             "MarkovGrid — use backend='markov'")
        from repro_torch.core.markov import solve_grid
        return solve_grid(grid, **kw).to_results()
    if backend == "gen":
        from repro_torch.core.gen_sweep import gen_sweep
        if not isinstance(grid, GenGrid):
            raise ValueError("backend 'gen' needs a GenGrid (token-level "
                             "axes); request-level grids have no "
                             "prompt/gen_tokens to promote")
        return gen_sweep(grid, **kw).to_results()
    if isinstance(grid, GenGrid):
        # request-level backends would misread the token-level axes
        raise ValueError(f"backend {backend!r} is request-level; this is "
                         "a GenGrid — use backend='gen'")
    if backend != "fleet" and isinstance(grid, FleetGrid) \
            and bool(np.any(grid.k > 1)):
        # single-server backends would silently read lam as one queue's
        # rate and ignore k/routing — a wrong "exact" reference
        raise ValueError(f"backend {backend!r} is single-server; this "
                         "FleetGrid has k > 1 points — use "
                         "backend='fleet'")
    if backend == "analytic":
        if kw:
            raise ValueError("backend 'analytic' accepts no keyword "
                             f"arguments (got {sorted(kw)})")
        return _analytic(grid)
    if backend == "markov":
        return _markov(grid, **kw)
    if backend == "sim":
        return _sim(grid, **kw)
    if backend == "sweep":
        from repro_torch.core.sweep import sweep
        if isinstance(grid, FleetGrid):
            raise ValueError("backend 'sweep' is single-server; use "
                             "backend='fleet' for a FleetGrid")
        return sweep(grid, **kw).to_results()
    if backend == "fleet":
        from repro_torch.core.sweep import fleet_sweep
        if not isinstance(grid, FleetGrid):
            # k = 1 reduces to the single-server model for every
            # routing; "random" runs the cheapest routing (no JSQ
            # water-filling)
            grid = FleetGrid.from_points(
                grid.lam, grid.alpha, grid.tau0, k=1, routing="random",
                b_max=grid.b_max, dist=grid.dist, cv=grid.cv,
                wait_max=grid.wait_max, wait_target=grid.wait_target,
                q_max=grid.q_max, deadline=grid.deadline,
                overflow=grid.overflow, retry_rate=grid.retry_rate,
                mtbf=grid.mtbf, mttr=grid.mttr,
                fail_disc=grid.fail_disc, throttle=grid.throttle)
        return fleet_sweep(grid, **kw).to_results()
    raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
