"""Stochastic-order machinery behind Theorem 1 — the port's copy.

Own copy of the reference package's ``repro.core.stochastic``: the port
imports nothing of ``repro``, not even this module, which loads no JAX.
The code is the reference's, unchanged.

The reference module's description follows.

Stochastic-order machinery behind Theorem 1 (monotone energy efficiency).

Provides the Poisson-mixture distributions a_k^[b] (Eq. 4) for the Example-1
service families and usual-stochastic-order checks, used by the property
tests to verify the two comparisons the theorem's proof rests on:

  (23)  A^[i],λ ≤_st A^[i'],λ   for i ≤ i'   (batch monotonicity)
  (24)  A^[i],λ1 ≤_st A^[i],λ2  for λ1 ≤ λ2  (arrival-rate monotonicity)

plus the end-to-end consequence B^(λ1) ≤_st B^(λ2) measured on simulation.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.analytic import LinearServiceModel
from repro_torch.core.markov import poisson_pmf_row

__all__ = ["a_pmf", "st_leq", "survival"]


def a_pmf(lam: float, b: int, model: LinearServiceModel, kmax: int,
          dist: str = "det", cv: float = 0.5, n_quad: int = 512
          ) -> np.ndarray:
    """pmf of A^[b] — number of Poisson(λ) arrivals during H^[b] (Eq. 4)."""
    mean = float(model.tau(b))
    if dist == "det":
        return poisson_pmf_row(lam * mean, kmax)
    if dist == "exp":
        # geometric mixture: P(A=k) = (1/(1+λm)) (λm/(1+λm))^k
        r = lam * mean
        p = (r / (1 + r)) ** np.arange(kmax + 1) / (1 + r)
        p[-1] += max(0.0, 1 - p.sum())
        return p
    if dist == "gamma":
        # numerical quadrature over gamma(k=1/cv², θ=mean·cv²)
        k = 1.0 / cv ** 2
        theta = mean / k
        # Gauss-Laguerre-ish grid: simple trapezoid on quantile grid
        qs = (np.arange(n_quad) + 0.5) / n_quad
        # inverse CDF via Wilson-Hilferty approx then Newton — keep simple:
        # use numpy's gamma ppf via scipy if present, else MC grid
        try:
            from scipy.stats import gamma as sg
            xs = sg.ppf(qs, k, scale=theta)
        except Exception:  # pragma: no cover
            rng = np.random.default_rng(0)
            xs = np.sort(rng.gamma(k, theta, size=n_quad))
        rows = np.stack([poisson_pmf_row(lam * float(x), kmax) for x in xs])
        p = rows.mean(axis=0)
        p /= p.sum()
        return p
    raise ValueError(dist)


def survival(pmf: np.ndarray) -> np.ndarray:
    """P(X >= k) for k = 0..len(pmf)-1."""
    return pmf[::-1].cumsum()[::-1]


def st_leq(pmf_x: np.ndarray, pmf_y: np.ndarray, tol: float = 1e-12) -> bool:
    """X ≤_st Y  ⇔  P(X≥k) ≤ P(Y≥k) ∀k (Definition 1)."""
    n = max(len(pmf_x), len(pmf_y))
    sx = survival(np.pad(pmf_x, (0, n - len(pmf_x))))
    sy = survival(np.pad(pmf_y, (0, n - len(pmf_y))))
    return bool(np.all(sx <= sy + tol))
