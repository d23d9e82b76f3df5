"""One entry point over the port's queue-evaluation backends.

``evaluate(grid, backend=...)`` mirrors the reference package's
``repro.core.evaluate`` for the backends this slice ports:

- ``"analytic"`` — closed form only (Theorem 2 + Remark 5 + Lemma 5):
  ``mean_latency`` is the upper bound φ, ``mean_batch`` the Remark-5
  lower bound, ``utilization`` the Lemma-5 upper bound.  Deterministic
  service, infinite b_max, no timeout — other points raise.
- ``"sweep"`` — the PyTorch Monte Carlo sweep (``repro_torch.core
  .sweep``), on CUDA unless ``device="cpu"``; keyword arguments pass
  through to it.
- ``"gen"`` — the token-level generate sweep (``repro_torch.core
  .gen_sweep``), likewise.  It takes a ``GenGrid``, and the
  request-level backends refuse one.

Both sweeps take loss grids (``q_max``, ``deadline``, ``overflow``,
``retry_rate``); their results carry ``goodput_frac``, ``reject_frac``,
``abandon_frac`` and ``retry_inflation``.  ``"analytic"`` refuses them.

Every other backend of the reference raises ``NotImplementedError``
naming the ROADMAP item that ports it.  Each call returns one
``SimResult`` per point, with the reference's field names.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core import analytic as an
from repro_torch.core.grid import DIST_CODE, GenGrid, SweepGrid
from repro_torch.core.results import SimResult

__all__ = ["evaluate", "BACKENDS"]

BACKENDS = ("analytic", "sweep", "gen")

# the reference's other backends and the ROADMAP items that port them
_NOT_PORTED = {
    "markov": "ROADMAP Queue A item 6 (chain solver)",
    "sim": "ROADMAP Queue A item 3a (scalar simulator reference)",
    "fleet": "ROADMAP Queue A item 4 (fleet_sweep)",
}


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
             "never breaks down)")
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


def evaluate(grid: SweepGrid, backend: str = "sweep",
             **kw) -> List[SimResult]:
    """Evaluate every grid point with the chosen backend (see module
    docstring); returns one ``SimResult`` per point.  The sweep fills
    each result's ``stderr``/``ci_halfwidth`` (batch means, nominal
    95%); the analytic backend leaves them NaN."""
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
    if backend == "analytic":
        if kw:
            raise ValueError("backend 'analytic' accepts no keyword "
                             f"arguments (got {sorted(kw)})")
        return _analytic(grid)
    if backend == "sweep":
        from repro_torch.core.sweep import sweep
        return sweep(grid, **kw).to_results()
    if backend in _NOT_PORTED:
        raise NotImplementedError(f"backend {backend!r} is not ported "
                                  f"yet: {_NOT_PORTED[backend]}")
    raise ValueError(f"unknown backend {backend!r}; pick from {BACKENDS}")
